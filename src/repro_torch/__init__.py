"""Hyft serving on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

Module paths mirror the JAX package (``repro.core.numerics`` ->
``repro_torch.core.numerics``); nothing here imports ``jax`` or ``repro``.
"""
