"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs a CUDA device and ``nvcc`` (the kernels build at first use); without
a card every test here skips.  No JAX: the machine with the card runs the
port alone.  Run there with ``python -m pytest -q -m gpu
tests/test_torch_kernels_gpu.py``; ``chip_smoke.py`` holds the same kernels
at the main path's full shapes.
"""
import dataclasses

import pytest
import torch

from repro_torch.core.hyft import HYFT16, HYFT32
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import fp2fx8_quantize

B, HQ, HKV, D = 2, 6, 2, 128


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _kv(gen, Sk, cache_dtype):
    k = torch.randn(B, HKV, Sk, D, generator=gen, device="cuda")
    v = torch.randn(B, HKV, Sk, D, generator=gen, device="cuda")
    if cache_dtype == "fp2fx8":
        (kr, ks), (vr, vs) = fp2fx8_quantize(k), fp2fx8_quantize(v)
        return kr, vr, {"k_scale": ks, "v_scale": vs}, v
    if cache_dtype == "bfloat16":
        return k.bfloat16(), v.bfloat16(), {}, v
    return k, v, {}, v


def _hold(cfg, q3, k, v, sc, mask, sq, vf):
    """The kernel against its plain version on the same folded inputs,
    within the bounds ``fa.tile_errors`` states; returns the kernel's
    level-1 stats."""
    Sk = k.shape[2]
    bk = fa._block_k(Sk, 256)
    flat = [t.reshape(B * HKV, Sk, *t.shape[3:]) if t is not None else None
            for t in (k, v, sc.get("k_scale"), sc.get("v_scale"))]
    kw = dict(cfg=cfg, sm_scale=D ** -0.5, bk=bk, hkv=HKV, sq=sq)
    got = fa._splitk_tiles_cuda(q3, *flat, mask, **kw)
    ref = fa.splitk_tiles_plain(q3, *flat, mask, **kw)
    err = fa.tile_errors(got, ref, cfg, float(vf.abs().max()), bk)
    assert err["m_loc"] <= 1 and err["l_loc"] <= 1 and err["out"] <= 1, err
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [HYFT16, HYFT32, dataclasses.replace(HYFT16, step=2)],
                         ids=["hyft16", "hyft32", "hyft16-step2"])
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8", "bfloat16"])
@pytest.mark.parametrize("Sk", [16, 300, 600])
def test_decode_kernel_matches_plain(Sk, cache_dtype, cfg):
    gen = _card()
    k, v, sc, vf = _kv(gen, Sk, cache_dtype)
    q = torch.randn(B, HQ, 1, D, generator=gen, device="cuda")
    mask = (torch.arange(Sk, device="cuda")[None]
            < torch.tensor([Sk, Sk // 3 + 1], device="cuda")[:, None]).float()
    got = _hold(cfg, q.reshape(B * HKV, HQ // HKV, D), k, v, sc, mask, None, vf)
    out = fa.flash_hyft_decode(q, k, v, cfg, kv_len_mask=mask, **sc)
    assert torch.equal(out, fa._splitk_combine(*got, cfg).reshape(out.shape))
    one = fa.flash_hyft_verify(q, k, v, mask[:, None], cfg, **sc)
    assert torch.equal(one, out)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
@pytest.mark.parametrize("Sq", [5, 40])
def test_verify_kernel_matches_plain(Sq, cache_dtype):
    gen = _card()
    Sk = 600
    k, v, sc, vf = _kv(gen, Sk, cache_dtype)
    q3 = torch.randn(B * HKV, HQ // HKV * Sq, D, generator=gen, device="cuda")
    start = torch.tensor([Sk - Sq, Sk // 3], device="cuda")
    pm = (torch.arange(Sk, device="cuda")[None, None]
          <= (start[:, None, None] + torch.arange(Sq, device="cuda")[None, :, None]))
    for cfg in (HYFT16, HYFT32):
        _hold(cfg, q3, k, v, sc, pm.float(), Sq, vf)


@pytest.mark.gpu
def test_kernel_rejects_bad_input():
    _card()
    q3 = torch.zeros(4, 6, 64, device="cuda")          # head width not built
    k3 = torch.zeros(4, 10, 64, device="cuda")
    mask = torch.ones(2, 10, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa._splitk_tiles_cuda(q3, k3, k3, None, None, mask, cfg=HYFT16,
                              sm_scale=0.125, bk=128, hkv=2, sq=None)
