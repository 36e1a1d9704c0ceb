"""Hyft numerics: fixed-point emulation, the softmax, the registry."""
