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


# --------------------------------------------------------------------------
# the flash kernels (training)
# --------------------------------------------------------------------------

# (id, causal, Sq, Sk, ragged mask, q_offset): 200 keys pad to 256
FLASH_CASES = [("causal", True, 256, 256, False, 0),
               ("masked-padded", False, 72, 200, True, 0),
               ("causal-offset-masked", True, 144, 200, True, 56)]


def _flash_inputs(gen, Sq, Sk, dtype, ragged):
    q = torch.randn(B, HQ, Sq, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, HKV, Sk, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, HKV, Sk, D, generator=gen, device="cuda").to(dtype)
    mask = None
    if ragged:
        mask = (torch.arange(Sk, device="cuda")[None]
                < torch.tensor([Sk, Sk // 3 + 1], device="cuda")[:, None]).float()
    return fa.flash_operands(q, k, v, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [HYFT16, HYFT32, dataclasses.replace(HYFT16, step=2)],
                         ids=["hyft16", "hyft32", "hyft16-step2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_kernels_match_plain(case, dtype, cfg):
    """Forward, dq and dk/dv kernels against their plain versions, called by
    name on the same padded inputs, within the bounds of ``flash_errors``
    and ``grad_errors``."""
    gen = _card()
    _, causal, Sq, Sk, ragged, q_offset = case
    q, k, v, maskf, bk = _flash_inputs(gen, Sq, Sk, dtype, ragged)
    q3, k3, v3 = fa._h3(q), fa._h3(k), fa._h3(v)
    kw = dict(cfg=cfg, sm_scale=D ** -0.5, causal=causal, bk=bk, group=HQ // HKV,
              q_offset=q_offset)
    got = fa._flash_fwd_cuda(q3, k3, v3, maskf, **kw)
    ref = fa._flash_fwd_plain(q3, k3, v3, maskf, **kw)
    err = fa.flash_errors(got, ref, cfg, float(v.float().abs().max()), bk, k3.shape[1] // bk)
    assert err["m"] <= 1 and err["l"] <= 1 and err["o"] <= 1, err
    do3 = torch.randn(q3.shape, generator=gen, device="cuda")
    args = (q3, k3, v3, maskf, do3, fa._flash_delta(do3, ref[0]).contiguous(), *ref[1:])
    gerr = fa.grad_errors(
        (fa._flash_bwd_dq_cuda(*args, **kw), *fa._flash_bwd_dkv_cuda(*args, **kw)),
        (fa._flash_bwd_dq_plain(*args, **kw), *fa._flash_bwd_dkv_plain(*args, **kw)),
        cfg)
    assert max(gerr["dq"], gerr["dk"], gerr["dv"]) <= 1, gerr


@pytest.mark.gpu
def test_flash_rejects_bad_input():
    _card()
    q3 = torch.zeros(4, 8, 64, device="cuda")          # head width not built
    with pytest.raises(ValueError, match="head dim"):
        fa._flash_fwd_cuda(q3, q3[:2], q3[:2], None, cfg=HYFT16, sm_scale=0.125,
                           causal=True, bk=8, group=2, q_offset=0)
    q3 = torch.zeros(4, 8, D, device="cuda")
    with pytest.raises(ValueError, match="dtypes"):
        fa._flash_fwd_cuda(q3, q3[:2].half(), q3[:2].half(), None, cfg=HYFT16,
                           sm_scale=0.125, causal=True, bk=8, group=2, q_offset=0)


@pytest.mark.gpu
def test_training_step_runs_on_the_flash_kernels():
    """One training step of a 2-layer model with 128-wide heads, remat
    "full": each layer's forward kernel runs twice (once more in the
    backward), dq and dk/dv once; the split-K kernels not at all."""
    _card()
    from repro_torch import optim
    from repro_torch.configs import TrainConfig, get_config, smoke_config
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.models import build_model
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_step_fn

    cfg = smoke_config(get_config("qwen2-1.5b")).with_(
        d_model=256, n_heads=4, n_kv_heads=2, d_head=D, softmax_impl="hyft16")
    model = build_model(cfg)
    ocfg = optim.OptConfig(lr=1e-3)
    state = init_state(model, ocfg, 0, device="cuda")
    step = make_step_fn(model, TrainConfig(warmup_steps=0, total_steps=4,
                                           attn_mode="kernel"), ocfg)
    batch = lm_batch(DataConfig(vocab=cfg.vocab, seq_len=160, global_batch=2), 0,
                     device="cuda")
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"hyft_splitk_decode": 0, "hyft_splitk_verify": 0,
                           "hyft_flash_fwd": 4, "hyft_flash_bwd_dq": 2,
                           "hyft_flash_bwd_dkv": 2}
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
