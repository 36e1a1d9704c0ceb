"""The port's configs against the JAX package's, on the CPU.

Each config's fields equal the JAX config's; its smoke config's
``forward`` (causal, and bidirectional for bert-base) matches the JAX
forward on the JAX weights through the weights bridge, fp32 compute, in
the unfused mode and in kernel mode (the plain versions of the kernels
against the Pallas kernels in interpret mode): hidden states within 1e-4
of their largest, ``tests/test_torch_generate.py``'s logits tolerance.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtransformer
from repro.models.layers import unbox
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer

RTOL = 1e-4
DENSE = ["bert-base", "olmo-1b", "mistral-nemo-12b", "nemotron-4-340b"]


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_jax(arch):
    assert arch in ARCHS
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    kw = dict(compute_dtype="float32")   # the configs' own softmax, hyft32
    tcfg, jcfg = smoke_config(cfg).with_(**kw), jax_smoke_config(jcfg).with_(**kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jparams = unbox(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    for causal in ((True, False) if arch == "bert-base" else (True,)):
        for mode in ("unfused", "kernel"):
            want, _ = jtransformer.forward(jparams, tokens, jcfg.with_(attn_mode=mode),
                                           remat="none", causal=causal)
            want = np.asarray(want)
            with torch.no_grad():
                got, _ = transformer.forward(tparams, torch.from_numpy(tokens),
                                             tcfg.with_(attn_mode=mode), remat="none",
                                             causal=causal)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_recurrent_config_matches_jax(arch):
    """The SSM and hybrid configs' fields equal the JAX configs', and so do
    their smoke configs' (state 16, heads of 16, chunks of 8; the hybrid 4
    layers with the shared block every 2).  Their models are held to JAX's
    in ``tests/test_torch_ssm.py`` and ``tests/test_torch_hybrid.py``."""
    assert arch in ARCHS
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(smoke_config(cfg)) == dataclasses.asdict(jax_smoke_config(jcfg))
    assert cfg.family in ("ssm", "hybrid") and smoke_config(cfg).ssm_chunk == 8


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "grok-1-314b"])
def test_moe_config_matches_jax(arch):
    """The MoE configs' fields equal the JAX configs', and so do their smoke
    configs' (4 experts, groups of 16).  Their models are held to JAX's in
    ``tests/test_torch_moe.py``."""
    assert arch in ARCHS
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(smoke_config(cfg)) == dataclasses.asdict(jax_smoke_config(jcfg))
    assert cfg.family == "moe" and smoke_config(cfg).n_experts == 4
