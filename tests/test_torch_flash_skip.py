"""The dq kernel's causal skip against the full walk, on the CPU: the six
``test_flash_dq_causal_skip_bounds`` cases of ``tests/test_torch_flash.py``,
whose helpers and data this module imports.  They sit in a file of their
own so that a run that hands out whole files to its workers (``--dist
loadfile``) runs them beside the rest of that module, not after it: they
take most of its time.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from test_torch_flash import (CONFIGS, SKIP_KEYS, _dq_skipped, _dq_stats, _dq_to,
                              _skip_inputs)


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_flash_dq_causal_skip_bounds(name, dtype):
    """The dq kernel's skip: dropping the key sub-tiles past a 64-row
    tile's causal frontier takes the last terms off each of its dq chains.
    On these inputs every row's masked term counts 0 (the kernel's guard),
    so the skip is allowed; under HYFT32 the masked probability is then
    exactly 0 and dq keeps every bit, under HYFT16 it stays within
    ``grad_errors`` of the full walk."""
    _, ct = CONFIGS[name]
    q3, k3, v3 = _skip_inputs(dtype)
    stats = _dq_stats(q3, k3, v3, None, ct)
    assert bool((tfa.masked_counts(stats[2], ct) == 0).all())
    full = _dq_to(q3, k3, v3, None, stats, ct, SKIP_KEYS)
    got = _dq_skipped(q3, k3, v3, None, stats, ct)
    if ct.total_bits == 24:
        assert torch.equal(got, full), name
    else:
        assert tfa.grad_errors((got,), (full,), ct)["dq"] <= 1
