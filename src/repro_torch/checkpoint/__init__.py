"""Atomic, restart-safe checkpoints (own copy of ``repro.checkpoint``)."""
