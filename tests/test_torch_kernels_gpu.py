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
from repro_torch.tree import tree_leaves

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
    """The one-launch kernel's output against its plain version on the same
    folded inputs, within the ``out`` bound of ``fa.out_errors``; returns
    the kernel's output."""
    Sk = k.shape[2]
    bk = fa._block_k(Sk, 256)
    flat = [t.reshape(-1, Sk, *t.shape[3:]) if t is not None else None
            for t in (k, v, sc.get("k_scale"), sc.get("v_scale"))]
    kw = dict(cfg=cfg, sm_scale=D ** -0.5, bk=bk, hkv=HKV, sq=sq)
    got = fa._splitk_attention_cuda(q3, *flat, mask, **kw)
    err = fa.out_errors(got, fa.splitk_tiles_plain(q3, *flat, mask, **kw), cfg,
                        float(vf.abs().max()))
    assert torch.isfinite(got).all() and err["out"] <= 1, err
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
    assert torch.equal(out, got.reshape(out.shape))
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
    q3 = torch.zeros(4, 6, 96, device="cuda")          # head width not built
    k3 = torch.zeros(4, 10, 96, device="cuda")
    mask = torch.ones(2, 10, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa._splitk_attention_cuda(q3, k3, k3, None, None, mask, cfg=HYFT16,
                                  sm_scale=0.125, bk=128, hkv=2, sq=None)
    q3 = torch.zeros(4, 6, D, device="cuda")
    k3 = torch.zeros(4, 10, D, device="cuda")
    with pytest.raises(ValueError, match="bk=512"):            # split size not built
        fa._splitk_attention_cuda(q3, k3, k3, None, None, mask, cfg=HYFT16,
                                  sm_scale=0.125, bk=512, hkv=2, sq=None)


# --------------------------------------------------------------------------
# the paged kernels (continuous serving over a page pool)
# --------------------------------------------------------------------------

NB = 6   # virtual blocks per sequence


def _paged(gen, ps, cache_dtype):
    """A pool of B * NB + 3 pages (page 0 the null page, random like the
    rest), a shuffled block table whose blocks past each sequence's length
    are the null page, and the (B, NB * ps) validity mask."""
    P = B * NB + 3
    k, v, sc, vf = _kv_pool(gen, (P, HKV, ps, D), cache_dtype)
    lengths = torch.tensor([NB * ps - 3, 2 * ps + 1], device="cuda")
    used = (-(-lengths // ps)).tolist()
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros(B, NB, dtype=torch.int32, device="cuda")
    bt[0, :used[0]] = perm[:used[0]].int()
    bt[1, :used[1]] = perm[used[0]:used[0] + used[1]].int()
    mask = (torch.arange(NB * ps, device="cuda")[None] < lengths[:, None]).float()
    return k, v, sc, vf, bt, mask, lengths


def _kv_pool(gen, shape, cache_dtype):
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if cache_dtype == "fp2fx8":
        (kr, ks), (vr, vs) = fp2fx8_quantize(k), fp2fx8_quantize(v)
        return kr, vr, {"k_scale": ks, "v_scale": vs}, v
    if cache_dtype == "bfloat16":
        return k.bfloat16(), v.bfloat16(), {}, v
    return k, v, {}, v


def _hold_paged(cfg, q3, k, v, sc, bt, mask, sq, vf):
    """The one-launch paged kernel's output against its plain version on
    the same inputs, within the ``out`` bound of ``fa.out_errors``; returns
    the kernel's output."""
    kw = dict(cfg=cfg, sm_scale=D ** -0.5, hkv=HKV, sq=sq)
    args = (q3, k, v, sc.get("k_scale"), sc.get("v_scale"), bt, mask)
    got = fa._paged_attention_cuda(*args, **kw)
    err = fa.out_errors(got, fa.paged_tiles_plain(*args, **kw), cfg,
                        float(vf.abs().max()))
    assert torch.isfinite(got).all() and err["out"] <= 1, err
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [HYFT16, HYFT32, dataclasses.replace(HYFT16, step=2)],
                         ids=["hyft16", "hyft32", "hyft16-step2"])
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8", "bfloat16"])
@pytest.mark.parametrize("ps", [8, 16, 64, 128])
def test_paged_decode_kernel_matches_plain(ps, cache_dtype, cfg):
    """Kernel 7 against its plain version, then through the wrapper: the
    same launch, and paged verify (kernel 9) at Sq = 1 bitwise."""
    gen = _card()
    k, v, sc, vf, bt, mask, _ = _paged(gen, ps, cache_dtype)
    q = torch.randn(B, HQ, 1, D, generator=gen, device="cuda")
    got = _hold_paged(cfg, q.reshape(B * HKV, HQ // HKV, D), k, v, sc, bt, mask,
                      None, vf)
    out = fa.flash_hyft_decode_paged(q, k, v, bt, cfg, kv_len_mask=mask, **sc)
    assert torch.equal(out, got.reshape(out.shape))
    one = fa.flash_hyft_verify(q, k, v, mask[:, None], cfg, block_tables=bt, **sc)
    assert torch.equal(one, out)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
@pytest.mark.parametrize("Sq", [5, 40])
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_paged_verify_kernel_matches_plain(ps, Sq, cache_dtype):
    """Kernel 9: a chunk ending at each sequence's length, lane t seeing
    keys up to length - Sq + t."""
    gen = _card()
    k, v, sc, vf, bt, _, lengths = _paged(gen, ps, cache_dtype)
    q3 = torch.randn(B * HKV, HQ // HKV * Sq, D, generator=gen, device="cuda")
    start = lengths - Sq
    pm = (torch.arange(NB * ps, device="cuda")[None, None]
          <= (start[:, None, None] + torch.arange(Sq, device="cuda")[None, :, None]))
    for cfg in (HYFT16, HYFT32):
        got = _hold_paged(cfg, q3, k, v, sc, bt, pm.float().contiguous(), Sq, vf)
        out = fa.flash_hyft_verify(q3.reshape(B, HQ, Sq, D), k, v, pm.float(), cfg,
                                   block_tables=bt, **sc)
        assert torch.equal(out, got.reshape(out.shape))


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
def test_paged_kernel_layout_invariances(cache_dtype):
    """Page placement changes no bit, and a sequential table over a
    contiguous pool is the contiguous decode kernel at bk = 64, bitwise."""
    gen = _card()
    ps = 64
    k, v, sc, _, bt, mask, _ = _paged(gen, ps, cache_dtype)
    q = torch.randn(B, HQ, 1, D, generator=gen, device="cuda")
    base = fa.flash_hyft_decode_paged(q, k, v, bt, HYFT16, kv_len_mask=mask, **sc)
    perm = torch.randperm(k.shape[0], generator=gen, device="cuda")
    inv = torch.argsort(perm).int()
    shuf = fa.flash_hyft_decode_paged(
        q, k[perm].contiguous(), v[perm].contiguous(), inv[bt.long()].contiguous(),
        HYFT16, kv_len_mask=mask, **{n: t[perm].contiguous() for n, t in sc.items()})
    assert torch.equal(base, shuf)
    Sk = NB * ps
    kc, vc, scc, _ = _kv(gen, Sk, cache_dtype)

    def pages(x):   # (B, Hkv, Sk[, D]) -> (B * NB, Hkv, ps[, D]), in order
        x = x.reshape(B, HKV, NB, ps, *x.shape[3:]).transpose(1, 2)
        return x.reshape(B * NB, HKV, ps, *x.shape[4:]).contiguous()
    seq = torch.arange(B * NB, dtype=torch.int32, device="cuda").reshape(B, NB)
    dense = fa.flash_hyft_decode(q, kc, vc, HYFT16, block_k=ps, kv_len_mask=mask, **scc)
    paged = fa.flash_hyft_decode_paged(q, pages(kc), pages(vc), seq, HYFT16,
                                       kv_len_mask=mask,
                                       **{n: pages(t) for n, t in scc.items()})
    assert torch.equal(dense, paged)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
@pytest.mark.parametrize("Sq", [1, 7])
@pytest.mark.parametrize("ps", [64, 256])
def test_paged_verify_sequential_pages_bitwise_contiguous(ps, Sq, cache_dtype):
    """Over a sequential table of pages of ``ps`` the paged kernels (7 and
    9) equal the contiguous ones (6 and 8) at bk = ps, bit for bit: both
    merge the splits on chip in the torch combine's order and ops."""
    gen = _card()
    Sk = NB * ps
    kc, vc, scc, _ = _kv(gen, Sk, cache_dtype)
    q = torch.randn(B, HQ, Sq, D, generator=gen, device="cuda")
    start = torch.tensor([Sk - Sq, 70], device="cuda")
    pm = (torch.arange(Sk, device="cuda")[None, None]
          <= (start[:, None, None] + torch.arange(Sq, device="cuda")[None, :, None]))
    pm = pm.float().contiguous()

    def pages(x):   # (B, Hkv, Sk[, D]) -> (B * NB, Hkv, ps[, D]), in order
        x = x.reshape(B, HKV, NB, ps, *x.shape[3:]).transpose(1, 2)
        return x.reshape(B * NB, HKV, ps, *x.shape[4:]).contiguous()
    seq = torch.arange(B * NB, dtype=torch.int32, device="cuda").reshape(B, NB)
    pool = (pages(kc), pages(vc), {n: pages(t) for n, t in scc.items()})
    dense = fa.flash_hyft_verify(q, kc, vc, pm, HYFT16, block_k=ps, **scc)
    paged = fa.flash_hyft_verify(q, pool[0], pool[1], pm, HYFT16, block_tables=seq,
                                 **pool[2])
    assert torch.equal(dense, paged)
    if Sq == 1:
        mask = pm[:, 0]
        dense = fa.flash_hyft_decode(q, kc, vc, HYFT16, block_k=ps, kv_len_mask=mask, **scc)
        paged = fa.flash_hyft_decode_paged(q, pool[0], pool[1], seq, HYFT16,
                                           kv_len_mask=mask, **pool[2])
        assert torch.equal(dense, paged)


@pytest.mark.gpu
def test_paged_kernel_rejects_bad_input():
    gen = _card()
    k, v, sc, _, bt, mask, _ = _paged(gen, 16, "float32")
    q3 = torch.randn(B * HKV, HQ // HKV, D, generator=gen, device="cuda")
    kw = dict(cfg=HYFT16, sm_scale=D ** -0.5, hkv=HKV, sq=None)
    k12 = torch.zeros(k.shape[0], HKV, 12, D, device="cuda")   # page size not built
    mask12 = torch.ones(B, NB * 12, device="cuda")
    with pytest.raises(ValueError, match="page size"):
        fa._paged_attention_cuda(q3, k12, k12, None, None, bt, mask12, **kw)
    with pytest.raises(ValueError, match="int32"):
        fa._paged_attention_cuda(q3, k, v, None, None, bt.long(), mask, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8", "bfloat16"])
@pytest.mark.parametrize("rows", [17, 24, 40], ids=["group-of-17", "group-of-24", "group-of-40"])
def test_paged_decode_kernel_serves_groups_past_16(rows, cache_dtype):
    """A cluster of kernel 7 computes at most 16 rows; a larger GQA group
    takes one cluster per 16 rows in the same launch, each row within the
    ``out`` bound of the plain version, and each row bitwise what a group
    of those rows alone gives."""
    gen = _card()
    k, v, sc, vf, bt, mask, _ = _paged(gen, 16, cache_dtype)
    q3 = torch.randn(B * HKV, rows, D, generator=gen, device="cuda")
    got = _hold_paged(HYFT16, q3, k, v, sc, bt, mask, None, vf)
    kw = dict(cfg=HYFT16, sm_scale=D ** -0.5, hkv=HKV, sq=None)
    for r0 in range(0, rows, 16):
        part = q3[:, r0:r0 + 16].contiguous()
        alone = fa._paged_attention_cuda(part, k, v, sc.get("k_scale"), sc.get("v_scale"),
                                         bt, mask, **kw)
        assert torch.equal(alone, got[:, r0:r0 + 16])


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
@pytest.mark.parametrize("batch, nb", [(B, 480), (1, 8192)], ids=["480-pages", "131072-keys"])
def test_decode_kernels_serve_long_sequences(batch, nb, cache_dtype):
    """Kernels 7 (pages of 16) and 6 (splits of 256) at 480 pages of 16 per
    sequence, and at 8192 pages (131,072 keys, B 1): within the ``out``
    bound of their plain versions, nothing refused.  Past the shared memory
    of one round the decode kernels take the splits in rounds."""
    gen = _card()
    ps, Sk = 16, nb * 16
    g = HQ // HKV
    k, v, sc, vf = _kv_pool(gen, (batch * nb + 1, HKV, ps, D), cache_dtype)
    bt = (torch.randperm(batch * nb, generator=gen, device="cuda") + 1).int().reshape(batch, nb)
    lengths = torch.tensor([Sk, Sk - 1000][:batch], device="cuda")
    mask = (torch.arange(Sk, device="cuda")[None] < lengths[:, None]).float()
    q3 = torch.randn(batch * HKV, g, D, generator=gen, device="cuda")
    _hold_paged(HYFT16, q3, k, v, sc, bt, mask, None, vf)
    kc, vc, scc, vfc = _kv_pool(gen, (batch, HKV, Sk, D), cache_dtype)
    kw = dict(cfg=HYFT16, sm_scale=D ** -0.5, bk=256, hkv=HKV, sq=None)
    flat = [t.reshape(batch * HKV, Sk, *t.shape[3:]) if t is not None else None
            for t in (kc, vc, scc.get("k_scale"), scc.get("v_scale"))]
    got = fa._splitk_attention_cuda(q3, *flat, mask, **kw)
    err = fa.out_errors(got, fa.splitk_tiles_plain(q3, *flat, mask, **kw), HYFT16,
                        float(vfc.abs().max()))
    assert torch.isfinite(got).all() and err["out"] <= 1, err


# --------------------------------------------------------------------------
# the flash kernels (training)
# --------------------------------------------------------------------------

# (id, causal, Sq, Sk, mask, q_offset): 200 keys pad to 256; "ragged"
# gives the batch entries lengths Sk and Sk // 3 + 1, "dead" masks keys 0-99
# of entry 1, so that its first 100 rows see no valid key (the kernels'
# causal skip must then keep every block)
FLASH_CASES = [("causal", True, 256, 256, None, 0),
               ("masked-padded", False, 72, 200, "ragged", 0),
               ("causal-offset-masked", True, 144, 200, "ragged", 56),
               ("causal-dead-rows", True, 256, 256, "dead", 0)]


def _flash_mask(kind, Sk, batch=B):
    if kind is None:
        return None
    keys = torch.arange(Sk, device="cuda")[None]
    if kind == "ragged":
        return (keys < torch.tensor([Sk, Sk // 3 + 1], device="cuda")[:, None]).float()
    mask = torch.ones(batch, Sk, device="cuda")
    mask[1, :100] = 0
    return mask


def _flash_inputs(gen, Sq, Sk, dtype, mask_kind, batch=B, hq=HQ):
    q = torch.randn(batch, hq, Sq, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(batch, HKV, Sk, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(batch, HKV, Sk, D, generator=gen, device="cuda").to(dtype)
    return fa.flash_operands(q, k, v, _flash_mask(mask_kind, Sk, batch))


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
    _, causal, Sq, Sk, mask_kind, q_offset = case
    q, k, v, maskf, bk = _flash_inputs(gen, Sq, Sk, dtype, mask_kind)
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
@pytest.mark.parametrize("cfg", [HYFT16, HYFT32], ids=["hyft16", "hyft32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_skip_matches_full(dtype, cfg):
    """At the training shape (B 4, Hq 12, Hkv 2, S 1024, causal) the forward
    that skips the causally masked KV blocks equals the one that walks them
    bit for bit; dq, whose chains lose their last (negligible) terms, is bit
    for bit under HYFT32 and within ``grad_errors`` under HYFT16, as dk/dv,
    whose chains lose their first.  On rows that see no valid key (keys
    0-99 of one batch entry masked) dq keeps the masked sub-tiles of their
    row tiles, without their scores, and is bit for bit there."""
    gen = _card()
    for batch, hq, S, mask_kind in ((4, 12, 1024, None), (B, HQ, 256, "dead")):
        q, k, v, maskf, bk = _flash_inputs(gen, S, S, dtype, mask_kind, batch=batch, hq=hq)
        q3, k3, v3 = fa._h3(q), fa._h3(k), fa._h3(v)
        kw = dict(cfg=cfg, sm_scale=D ** -0.5, causal=True, bk=bk, group=hq // HKV,
                  q_offset=0)
        got = fa._flash_fwd_cuda(q3, k3, v3, maskf, **kw)
        full = fa._flash_fwd_cuda(q3, k3, v3, maskf, **kw, skip_masked=False)
        for a, b in zip(got, full):
            assert torch.equal(a, b)
        do3 = torch.randn(q3.shape, generator=gen, device="cuda")
        args = (q3, k3, v3, maskf, do3, fa._flash_delta(do3, got[0]).contiguous(), *got[1:])
        dq = fa._flash_bwd_dq_cuda(*args, **kw)
        dq_full = fa._flash_bwd_dq_cuda(*args, **kw, skip_masked=False)
        dkv = fa._flash_bwd_dkv_cuda(*args, **kw)
        dkv_full = fa._flash_bwd_dkv_cuda(*args, **kw, skip_masked=False)
        gerr = fa.grad_errors((dq, *dkv), (dq_full, *dkv_full), cfg)
        kept = fa.dq_kept_rows(got[1], cfg)
        print({"case": mask_kind, "kept_rows": int(kept.sum()),
               "differing": [int((a != b).sum()) for a, b in
                             zip((dq, *dkv), (dq_full, *dkv_full))], **gerr})
        assert max(gerr["dq"], gerr["dk"], gerr["dv"]) <= 1, gerr
        assert torch.equal(dq[kept], dq_full[kept])
        assert mask_kind != "dead" or int(kept.sum()) > 0
        if cfg is HYFT32:
            assert torch.equal(dq, dq_full)


@pytest.mark.gpu
def test_flash_rejects_bad_input():
    _card()
    q3 = torch.zeros(4, 8, 96, device="cuda")          # head width not built
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
                           "hyft_paged_decode": 0, "hyft_paged_verify": 0,
                           "hyft_flash_fwd": 4, "hyft_flash_bwd_dq": 2,
                           "hyft_flash_bwd_dkv": 2}
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


# --------------------------------------------------------------------------
# head width 64 (bert-base, whisper-medium, internvl2-1b): kernels 3-9
# --------------------------------------------------------------------------

W64 = 64
# (hq, hkv): bert-base's 12 / 12 heads (a GQA group of 1) and a group of 3
GROUPS64 = [(12, 12), (6, 2)]
GROUP_IDS = ["group-1", "group-3"]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [HYFT16, HYFT32], ids=["hyft16", "hyft32"])
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8", "bfloat16"])
@pytest.mark.parametrize("hq, hkv", GROUPS64, ids=GROUP_IDS)
def test_split_k_kernels_match_plain_at_width_64(hq, hkv, cache_dtype, cfg):
    """Kernels 6 (decode, ragged lengths over 600 keys in splits of 256) and
    8 (a chunk of 40 lanes ending at each length) at D = 64 against their
    plain versions, within the ``out`` bound; through the wrappers, chunk
    attention at Sq = 1 is decode bit for bit."""
    gen = _card()
    Sk, Sq = 600, 40
    k, v, sc, vf = _kv_pool(gen, (B, hkv, Sk, W64), cache_dtype)
    lengths = torch.tensor([Sk, Sk // 3 + 1], device="cuda")
    mask = (torch.arange(Sk, device="cuda")[None] < lengths[:, None]).float()
    lane = (torch.arange(Sk, device="cuda")[None, None]
            <= (lengths[:, None, None] - Sq + torch.arange(Sq, device="cuda")[None, :, None]))
    flat = [t.reshape(B * hkv, Sk, *t.shape[3:]) if t is not None else None
            for t in (k, v, sc.get("k_scale"), sc.get("v_scale"))]
    kw = dict(cfg=cfg, sm_scale=W64 ** -0.5, bk=256, hkv=hkv)
    g = hq // hkv
    q1 = torch.randn(B, hq, 1, W64, generator=gen, device="cuda")
    qc = torch.randn(B * hkv, g * Sq, W64, generator=gen, device="cuda")
    for q3, m, sq in ((q1.reshape(B * hkv, g, W64), mask, None),
                      (qc, lane.float().contiguous(), Sq)):
        got = fa._splitk_attention_cuda(q3, *flat, m, **kw, sq=sq)
        err = fa.out_errors(got, fa.splitk_tiles_plain(q3, *flat, m, **kw, sq=sq), cfg,
                            float(vf.abs().max()))
        assert torch.isfinite(got).all() and err["out"] <= 1, err
    out = fa.flash_hyft_decode(q1, k, v, cfg, kv_len_mask=mask, **sc)
    one = fa.flash_hyft_verify(q1, k, v, mask[:, None], cfg, **sc)
    assert torch.equal(one, out)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8", "bfloat16"])
@pytest.mark.parametrize("ps", [16, 64, 256])
@pytest.mark.parametrize("hq, hkv", GROUPS64, ids=GROUP_IDS)
def test_paged_kernels_match_plain_at_width_64(hq, hkv, ps, cache_dtype):
    """Kernels 7 and 9 at D = 64 over a shuffled table (the null page past
    each length), HYFT16 and HYFT32, against their plain versions within the
    ``out`` bound; over a sequential table of pages of 64 or 256 they equal
    the contiguous kernels at bk = ps bit for bit."""
    gen = _card()
    nb, Sq = 6, 24
    Sk = nb * ps
    lengths = torch.tensor([Sk - 3, 2 * ps + 1], device="cuda")
    used = (-(-lengths // ps)).tolist()
    P = B * nb + 1
    k, v, sc, vf = _kv_pool(gen, (P, hkv, ps, W64), cache_dtype)
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros(B, nb, dtype=torch.int32, device="cuda")
    bt[0, :used[0]] = perm[:used[0]].int()
    bt[1, :used[1]] = perm[used[0]:used[0] + used[1]].int()
    mask = (torch.arange(Sk, device="cuda")[None] < lengths[:, None]).float()
    lane = (torch.arange(Sk, device="cuda")[None, None]
            <= (lengths[:, None, None] - Sq + torch.arange(Sq, device="cuda")[None, :, None]))
    lane = lane.float().contiguous()
    g = hq // hkv
    q1 = torch.randn(B * hkv, g, W64, generator=gen, device="cuda")
    qc = torch.randn(B * hkv, g * Sq, W64, generator=gen, device="cuda")
    for cfg in (HYFT16, HYFT32):
        kw = dict(cfg=cfg, sm_scale=W64 ** -0.5, hkv=hkv)
        for q3, m, sq in ((q1, mask, None), (qc, lane, Sq)):
            args = (q3, k, v, sc.get("k_scale"), sc.get("v_scale"), bt, m)
            got = fa._paged_attention_cuda(*args, **kw, sq=sq)
            err = fa.out_errors(got, fa.paged_tiles_plain(*args, **kw, sq=sq), cfg,
                                float(vf.abs().max()))
            assert torch.isfinite(got).all() and err["out"] <= 1, err
    if ps not in fa._SPLIT_SIZES:   # no contiguous kernel splits at ps
        return
    seq = torch.arange(1, B * nb + 1, dtype=torch.int32, device="cuda").reshape(B, nb)

    def contiguous(x):   # the pool's pages 1.. in table order: (B, Hkv, Sk[, D])
        x = x[1:].reshape(B, nb, hkv, ps, *x.shape[3:]).transpose(1, 2)
        return x.reshape(B, hkv, Sk, *x.shape[4:]).contiguous()
    cont = {n: contiguous(t) for n, t in sc.items()}
    q = qc.reshape(B, hq, Sq, W64)
    paged = fa.flash_hyft_verify(q, k, v, lane, HYFT16, block_tables=seq, **sc)
    dense = fa.flash_hyft_verify(q, contiguous(k), contiguous(v), lane, HYFT16,
                                 block_k=ps, **cont)
    assert torch.equal(dense, paged)
    q = q1.reshape(B, hq, 1, W64)
    paged = fa.flash_hyft_decode_paged(q, k, v, seq, HYFT16, kv_len_mask=mask, **sc)
    dense = fa.flash_hyft_decode(q, contiguous(k), contiguous(v), HYFT16, block_k=ps,
                                 kv_len_mask=mask, **cont)
    assert torch.equal(dense, paged)


# (id, causal, Sq, Sk, mask, q_offset) at D = 64: bert's non-causal shape,
# keys padded to the block under a ragged mask, a causal tile, dead rows
FLASH_CASES64 = [("noncausal", False, 128, 128, None, 0),
                 ("masked-padded", False, 72, 200, "ragged", 0),
                 ("causal-offset-masked", True, 144, 200, "ragged", 56),
                 ("causal-dead-rows", True, 256, 256, "dead", 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [HYFT16, HYFT32], ids=["hyft16", "hyft32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hq, hkv", GROUPS64, ids=GROUP_IDS)
@pytest.mark.parametrize("case", FLASH_CASES64, ids=[c[0] for c in FLASH_CASES64])
def test_flash_kernels_match_plain_at_width_64(case, hq, hkv, dtype, cfg):
    """Kernels 3, 4 and 5 at D = 64 against their plain versions, called by
    name on the same padded inputs, within ``flash_errors`` and
    ``grad_errors``; on a causal case the forward that skips the masked
    blocks equals the one that walks them, bit for bit."""
    gen = _card()
    _, causal, Sq, Sk, mask_kind, q_offset = case
    q = torch.randn(B, hq, Sq, W64, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, hkv, Sk, W64, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, hkv, Sk, W64, generator=gen, device="cuda").to(dtype)
    q, k, v, maskf, bk = fa.flash_operands(q, k, v, _flash_mask(mask_kind, Sk))
    q3, k3, v3 = fa._h3(q), fa._h3(k), fa._h3(v)
    kw = dict(cfg=cfg, sm_scale=W64 ** -0.5, causal=causal, bk=bk, group=hq // hkv,
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
    if causal:
        full = fa._flash_fwd_cuda(q3, k3, v3, maskf, **kw, skip_masked=False)
        assert all(map(torch.equal, got, full))


@pytest.mark.gpu
def test_kernels_refuse_width_96():
    """A CUDA tensor of a head width the kernels are not built for (96 lies
    between the configs' 64 and 112) raises a ValueError that names the
    widths they take: flash, split-K and paged."""
    _card()
    q3 = torch.zeros(4, 8, 96, device="cuda")
    with pytest.raises(ValueError, match=r"head dim 96 not in \(16, 64, 112, 128, 192\)"):
        fa._flash_fwd_cuda(q3, q3[:2], q3[:2], None, cfg=HYFT16, sm_scale=0.1,
                           causal=False, bk=8, group=2, q_offset=0)
    mask = torch.ones(2, 8, device="cuda")
    q1 = q3[:, :1].contiguous()
    with pytest.raises(ValueError, match=r"head dim 96 not in \(16, 64, 112, 128, 192\)"):
        fa._splitk_attention_cuda(q1, q3, q3, None, None, mask, cfg=HYFT16,
                                  sm_scale=0.1, bk=64, hkv=2, sq=None)
    pool = torch.zeros(5, 2, 8, 96, device="cuda")
    bt = torch.ones(2, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match=r"head dim 96 not in \(16, 64, 112, 128, 192\)"):
        fa._paged_attention_cuda(q1, pool, pool, None, None, bt, mask, cfg=HYFT16,
                                 sm_scale=0.1, hkv=2, sq=None)


# --------------------------------------------------------------------------
# head widths 16 (the smoke models, so the model drafter), 112 (zamba2-7b)
# and 192 (nemotron-4-340b): kernels 3-9, laid out at D rounded up to 64
# --------------------------------------------------------------------------

# (d, hq, hkv): the drafter's 4 / 2 heads; zamba2's group of 1 (32 / 32 cut
# to 4 / 4); nemotron's group of 12 (96 / 8 cut to 24 / 2)
WIDTHS = [(16, 4, 2), (112, 4, 4), (192, 24, 2)]
WIDTH_IDS = ["d16", "d112", "d192"]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [HYFT16, HYFT32], ids=["hyft16", "hyft32"])
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8", "bfloat16"])
@pytest.mark.parametrize("d, hq, hkv", WIDTHS, ids=WIDTH_IDS)
def test_split_k_kernels_match_plain_at_new_widths(d, hq, hkv, cache_dtype, cfg):
    """Kernels 6 and 8 at D = 16, 112 and 192 against their plain versions
    (ragged lengths over 600 keys in splits of 256, a chunk of 5 lanes and
    one of 40), within the ``out`` bound; chunk attention at Sq = 1 is
    decode bit for bit."""
    gen = _card()
    Sk = 600
    k, v, sc, vf = _kv_pool(gen, (B, hkv, Sk, d), cache_dtype)
    lengths = torch.tensor([Sk, Sk // 3 + 1], device="cuda")
    mask = (torch.arange(Sk, device="cuda")[None] < lengths[:, None]).float()
    flat = [t.reshape(B * hkv, Sk, *t.shape[3:]) if t is not None else None
            for t in (k, v, sc.get("k_scale"), sc.get("v_scale"))]
    kw = dict(cfg=cfg, sm_scale=d ** -0.5, bk=256, hkv=hkv)
    g = hq // hkv
    q1 = torch.randn(B, hq, 1, d, generator=gen, device="cuda")
    cases = [(q1.reshape(B * hkv, g, d), mask, None)]
    for Sq in (5, 40):
        lane = (torch.arange(Sk, device="cuda")[None, None]
                <= (lengths[:, None, None] - Sq + torch.arange(Sq, device="cuda")[None, :, None]))
        qc = torch.randn(B * hkv, g * Sq, d, generator=gen, device="cuda")
        cases.append((qc, lane.float().contiguous(), Sq))
    for q3, m, sq in cases:
        got = fa._splitk_attention_cuda(q3, *flat, m, **kw, sq=sq)
        err = fa.out_errors(got, fa.splitk_tiles_plain(q3, *flat, m, **kw, sq=sq), cfg,
                            float(vf.abs().max()))
        assert torch.isfinite(got).all() and err["out"] <= 1, err
    out = fa.flash_hyft_decode(q1, k, v, cfg, kv_len_mask=mask, **sc)
    one = fa.flash_hyft_verify(q1, k, v, mask[:, None], cfg, **sc)
    assert torch.equal(one, out)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8", "bfloat16"])
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("d, hq, hkv", WIDTHS, ids=WIDTH_IDS)
def test_paged_kernels_match_plain_at_new_widths(d, hq, hkv, ps, cache_dtype):
    """Kernels 7 and 9 at D = 16, 112 and 192 over a shuffled table (the
    null page past each length), HYFT16 and HYFT32, against their plain
    versions within the ``out`` bound; over a sequential table of pages of
    64 they equal the contiguous kernels at bk = 64 bit for bit."""
    gen = _card()
    nb, Sq = 6, 5
    Sk = nb * ps
    lengths = torch.tensor([Sk - 3, 2 * ps + 1], device="cuda")
    used = (-(-lengths // ps)).tolist()
    P = B * nb + 1
    k, v, sc, vf = _kv_pool(gen, (P, hkv, ps, d), cache_dtype)
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros(B, nb, dtype=torch.int32, device="cuda")
    bt[0, :used[0]] = perm[:used[0]].int()
    bt[1, :used[1]] = perm[used[0]:used[0] + used[1]].int()
    mask = (torch.arange(Sk, device="cuda")[None] < lengths[:, None]).float()
    lane = (torch.arange(Sk, device="cuda")[None, None]
            <= (lengths[:, None, None] - Sq + torch.arange(Sq, device="cuda")[None, :, None]))
    lane = lane.float().contiguous()
    g = hq // hkv
    q1 = torch.randn(B * hkv, g, d, generator=gen, device="cuda")
    qc = torch.randn(B * hkv, g * Sq, d, generator=gen, device="cuda")
    for cfg in (HYFT16, HYFT32):
        kw = dict(cfg=cfg, sm_scale=d ** -0.5, hkv=hkv)
        for q3, m, sq in ((q1, mask, None), (qc, lane, Sq)):
            args = (q3, k, v, sc.get("k_scale"), sc.get("v_scale"), bt, m)
            got = fa._paged_attention_cuda(*args, **kw, sq=sq)
            err = fa.out_errors(got, fa.paged_tiles_plain(*args, **kw, sq=sq), cfg,
                                float(vf.abs().max()))
            assert torch.isfinite(got).all() and err["out"] <= 1, err
    if ps not in fa._SPLIT_SIZES:
        return
    seq = torch.arange(1, B * nb + 1, dtype=torch.int32, device="cuda").reshape(B, nb)

    def contiguous(x):   # the pool's pages 1.. in table order: (B, Hkv, Sk[, D])
        x = x[1:].reshape(B, nb, hkv, ps, *x.shape[3:]).transpose(1, 2)
        return x.reshape(B, hkv, Sk, *x.shape[4:]).contiguous()
    cont = {n: contiguous(t) for n, t in sc.items()}
    q = qc.reshape(B, hq, Sq, d)
    paged = fa.flash_hyft_verify(q, k, v, lane, HYFT16, block_tables=seq, **sc)
    dense = fa.flash_hyft_verify(q, contiguous(k), contiguous(v), lane, HYFT16,
                                 block_k=ps, **cont)
    assert torch.equal(dense, paged)
    q = q1.reshape(B, hq, 1, d)
    paged = fa.flash_hyft_decode_paged(q, k, v, seq, HYFT16, kv_len_mask=mask, **sc)
    dense = fa.flash_hyft_decode(q, contiguous(k), contiguous(v), HYFT16, block_k=ps,
                                 kv_len_mask=mask, **cont)
    assert torch.equal(dense, paged)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [HYFT16, HYFT32], ids=["hyft16", "hyft32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d, hq, hkv", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("case", FLASH_CASES64, ids=[c[0] for c in FLASH_CASES64])
def test_flash_kernels_match_plain_at_new_widths(case, d, hq, hkv, dtype, cfg):
    """Kernels 3, 4 and 5 at D = 16, 112 and 192 against their plain
    versions, within ``flash_errors`` and ``grad_errors``; on a causal case
    the forward that skips the masked blocks equals the full walk, bit for
    bit."""
    gen = _card()
    _, causal, Sq, Sk, mask_kind, q_offset = case
    q = torch.randn(B, hq, Sq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, hkv, Sk, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, hkv, Sk, d, generator=gen, device="cuda").to(dtype)
    q, k, v, maskf, bk = fa.flash_operands(q, k, v, _flash_mask(mask_kind, Sk))
    q3, k3, v3 = fa._h3(q), fa._h3(k), fa._h3(v)
    kw = dict(cfg=cfg, sm_scale=d ** -0.5, causal=causal, bk=bk, group=hq // hkv,
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
    if causal:
        full = fa._flash_fwd_cuda(q3, k3, v3, maskf, **kw, skip_masked=False)
        assert all(map(torch.equal, got, full))


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("d, hq, hkv", [(16, 4, 2), (128, 32, 8)], ids=["d16", "d128"])
def test_verify_lanes_are_decode_at_their_frontier(d, hq, hkv, paged, cache_dtype):
    """The property that makes speculative decoding exact on the card: lane
    j of a chunk of 5 (kernel 8, or 9 over pages of 16) is bit for bit the
    decode kernel (6, or 7) run at lane j's causal frontier L + j."""
    gen = _card()
    Sq, ps, nb = 5, 16, 8
    Sk = nb * ps
    k, v, sc, _ = _kv_pool(gen, (B, hkv, Sk, d), cache_dtype)
    base = torch.tensor([Sk - Sq, 37], device="cuda")
    pos = base[:, None] + torch.arange(Sq, device="cuda")[None]
    lane = (torch.arange(Sk, device="cuda")[None, None] <= pos[:, :, None]).float()
    q = torch.randn(B, hq, Sq, d, generator=gen, device="cuda")
    if paged:
        def pages(x):    # (B, Hkv, Sk[, D]) -> pages 1.. in order, page 0 null
            x = x.reshape(B, hkv, nb, ps, *x.shape[3:]).transpose(1, 2)
            x = x.reshape(B * nb, hkv, ps, *x.shape[4:])
            return torch.cat([torch.zeros_like(x[:1]), x]).contiguous()
        k, v = pages(k), pages(v)
        sc = {n: pages(t) for n, t in sc.items()}
        bt = torch.arange(1, B * nb + 1, dtype=torch.int32, device="cuda").reshape(B, nb)
        ver = fa.flash_hyft_verify(q, k, v, lane, HYFT16, block_tables=bt, **sc)
    else:
        ver = fa.flash_hyft_verify(q, k, v, lane, HYFT16, **sc)
    for j in range(Sq):
        mj = lane[:, j].contiguous()
        if paged:
            dec = fa.flash_hyft_decode_paged(q[:, :, j:j + 1], k, v, bt, HYFT16,
                                             kv_len_mask=mj, **sc)
        else:
            dec = fa.flash_hyft_decode(q[:, :, j:j + 1], k, v, HYFT16, kv_len_mask=mj, **sc)
        assert torch.equal(dec, ver[:, :, j:j + 1]), j


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8", "bfloat16"])
@pytest.mark.parametrize("d, hq, hkv", [(16, 4, 2), (112, 4, 4)], ids=["d16", "d112"])
def test_narrow_widths_are_the_padded_layout_bitwise(d, hq, hkv, cache_dtype):
    """The design of the widths off the 64-column layouts: D 16 and 112 run
    at kDP = 64 and 128 with the columns past D zeroed, so kernels 3-9 at D
    equal the same kernels at kDP on operands zero-padded to kDP, bit for
    bit (the padded columns' outputs are zero), HYFT16 and HYFT32."""
    gen = _card()
    dp = -(-d // 64) * 64

    def pad(t):   # zero columns d..dp-1, in device memory (the test's own copy)
        return torch.nn.functional.pad(t, (0, dp - d)) if t.dtype != torch.int8 else \
            torch.cat([t, torch.zeros(*t.shape[:-1], dp - d, dtype=t.dtype, device="cuda")], -1)
    Sk, Sq, ps, nb = 600, 5, 16, 40
    k, v, sc, _ = _kv_pool(gen, (B * hkv, Sk, d), cache_dtype)
    lengths = torch.tensor([Sk, Sk // 3 + 1], device="cuda")
    mask = (torch.arange(Sk, device="cuda")[None] < lengths[:, None]).float()
    lane = (torch.arange(Sk, device="cuda")[None, None]
            <= (lengths[:, None, None] - Sq + torch.arange(Sq, device="cuda")[None, :, None]))
    lane = lane.float().contiguous()
    kp, vp, scp, _ = _kv_pool(gen, (B * nb + 1, hkv, ps, d), cache_dtype)
    bt = (torch.randperm(B * nb, generator=gen, device="cuda") + 1).int().reshape(B, nb)
    pmask = (torch.arange(nb * ps, device="cuda")[None] < lengths[:, None]).float()
    plane = (torch.arange(nb * ps, device="cuda")[None, None]
             <= (lengths[:, None, None] - Sq + torch.arange(Sq, device="cuda")[None, :, None]))
    plane = plane.float().contiguous()
    g = hq // hkv
    q1 = torch.randn(B * hkv, g, d, generator=gen, device="cuda")
    qc = torch.randn(B * hkv, g * Sq, d, generator=gen, device="cuda")
    for cfg in (HYFT16, HYFT32):
        for q3, m, pm, sq in ((q1, mask, pmask, None), (qc, lane, plane, Sq)):
            kw = dict(cfg=cfg, sm_scale=d ** -0.5, hkv=hkv, sq=sq)
            got = fa._splitk_attention_cuda(q3, k, v, sc.get("k_scale"), sc.get("v_scale"), m,
                                            bk=256, **kw)
            ref = fa._splitk_attention_cuda(pad(q3), pad(k), pad(v), sc.get("k_scale"),
                                            sc.get("v_scale"), m, bk=256, **kw)
            assert torch.equal(got, ref[..., :d]) and not ref[..., d:].any()
            got = fa._paged_attention_cuda(q3, kp, vp, scp.get("k_scale"), scp.get("v_scale"),
                                           bt, pm, **kw)
            ref = fa._paged_attention_cuda(pad(q3), pad(kp), pad(vp), scp.get("k_scale"),
                                           scp.get("v_scale"), bt, pm, **kw)
            assert torch.equal(got, ref[..., :d]) and not ref[..., d:].any()
    if cache_dtype == "fp2fx8":
        return
    dtype = torch.float32 if cache_dtype == "float32" else torch.bfloat16
    q3 = torch.randn(B * hq, 256, d, generator=gen, device="cuda").to(dtype)
    k3 = torch.randn(B * hkv, 256, d, generator=gen, device="cuda").to(dtype)
    v3 = torch.randn(B * hkv, 256, d, generator=gen, device="cuda").to(dtype)
    do3 = torch.randn(B * hq, 256, d, generator=gen, device="cuda")
    for cfg in (HYFT16, HYFT32):
        kw = dict(cfg=cfg, sm_scale=d ** -0.5, causal=True, bk=128, group=g, q_offset=0)
        o, m, l = fa._flash_fwd_cuda(q3, k3, v3, None, **kw)
        ref = fa._flash_fwd_cuda(pad(q3), pad(k3), pad(v3), None, **kw)
        assert torch.equal(o, ref[0][..., :d]) and torch.equal(m, ref[1]) and torch.equal(l, ref[2])
        args = (q3, k3, v3, None, do3, fa._flash_delta(do3, o).contiguous(), m, l)
        pargs = (pad(q3), pad(k3), pad(v3), None, pad(do3),
                 fa._flash_delta(do3, o).contiguous(), m, l)
        dq, (dk, dv) = fa._flash_bwd_dq_cuda(*args, **kw), fa._flash_bwd_dkv_cuda(*args, **kw)
        rdq, (rdk, rdv) = fa._flash_bwd_dq_cuda(*pargs, **kw), fa._flash_bwd_dkv_cuda(*pargs, **kw)
        assert torch.equal(dq, rdq[..., :d]) and torch.equal(dk, rdk[..., :d])
        assert torch.equal(dv, rdv[..., :d])


# --------------------------------------------------------------------------
# the standalone softmax kernels (TPU kernels 1 and 2)
# --------------------------------------------------------------------------


def _softmax_case(gen, shape, scale, dtype):
    """Seeded scores with a ragged causal-style mask (row r keeps its first
    r % cols + 1 keys) and a seeded dy, both of ``dtype``."""
    from repro_torch.kernels.flash_attention import NEG_BIG
    z = torch.randn(shape, generator=gen, device="cuda") * scale
    cols = shape[-1]
    rows = z.numel() // cols
    keep = (torch.arange(rows, device="cuda") % cols + 1)[:, None]
    live = torch.arange(cols, device="cuda")[None] < keep
    z = torch.where(live, z.reshape(rows, cols), NEG_BIG).reshape(shape)
    if dtype == torch.float16:
        z = z.clamp(min=-6e4)
    dy = torch.randn(shape, generator=gen, device="cuda")
    return z.to(dtype), dy


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["f32", "f16", "bf16"])
@pytest.mark.parametrize("cfg", [HYFT16, HYFT32, dataclasses.replace(HYFT16, io_dtype="bfloat16"),
                                 dataclasses.replace(HYFT32, step=4)],
                         ids=["hyft16", "hyft32", "hyft16b", "hyft32-step4"])
@pytest.mark.parametrize("shape", [(37, 200), (3, 5, 64), (7, 1), (2, 9000), (64, 1056),
                                   (2113, 1280), (2112, 1281), (2115, 1001), (2111, 1024),
                                   (2112, 256), (2113, 500), (2112, 3)])
def test_softmax_kernels_match_plain(shape, cfg, dtype):
    """Both kernels against their plain versions on the same inputs: bit for
    bit in every row within the sum precondition, within the stated bound
    past it (forward); block_rows changes nothing; the backward's fp32 dz
    (``out_dtype``) is its ``cfg.dtype`` dz widened, bit for bit.  9000
    columns do not fit the shared-memory stage, so they take the passes
    over device memory.  The warp-per-row path of both kernels (2112 rows
    or more, at most 1280 columns) at its edges: the column cap with a row
    count that is not a multiple of a block's 4 rows, unaligned rows of
    1001 columns, rows far shorter than its narrower width (256, 500) and
    shorter than one 16-byte chunk (3); 1281 columns and 2111 rows take the
    block path."""
    from repro_torch.kernels import hyft_softmax as hs
    gen = _card()
    z, dy = _softmax_case(gen, shape, 3.0, dtype)
    s = hs.hyft_softmax_fwd_kernel(z, cfg)
    ref = hs.hyft_softmax_fwd(z, cfg)
    err = hs.softmax_errors(s, ref, hs.fwd_sum_units(z, cfg), cfg)
    assert s.dtype == cfg.dtype and s.shape == z.shape
    assert err["mismatches"] == 0 and err["past_ratio"] <= 1, err
    assert torch.equal(hs.hyft_softmax_fwd_kernel(z, cfg, block_rows=3), s)
    dy = dy.to(s.dtype)
    units = hs.bwd_sum_units(s, dy, cfg)
    assert int(units.max()) <= hs.EXACT_UNITS
    dz = hs.hyft_softmax_bwd_kernel(s, dy, cfg)
    plain = hs.hyft_softmax_bwd(s, dy, cfg)
    berr = hs.softmax_errors(dz, plain, units, cfg)
    assert berr["mismatches"] == 0, berr
    assert torch.equal(hs.hyft_softmax_bwd_kernel(s, dy, cfg, block_rows=4), dz)
    dz32 = hs.hyft_softmax_bwd_kernel(s, dy, cfg, out_dtype=torch.float32)
    assert dz32.dtype == torch.float32 and torch.equal(dz32, dz.float())
    berr = hs.softmax_errors(dz32, plain.float(), units, cfg)
    assert berr["mismatches"] == 0, berr


def _bwd_exact_sum(s, dy, cfg):
    """The backward with its dot taken as the exact int64 sum of the
    elements' counts, rounded to fp32 once: the kernel's arithmetic on
    every row, also past the sum precondition, where the plain version's
    fp32 sum depends on its order."""
    from repro_torch.core import numerics as nm
    s32, dy32 = s.float(), dy.float()
    p = nm.log_mul(dy32, s32, cfg.mant_bits, half_range=True)
    units = torch.floor(p * 2.0 ** cfg.bwd_acc_bits).to(torch.int64).sum(-1, keepdim=True)
    dot = units.to(torch.float32) * 2.0 ** -cfg.bwd_acc_bits
    diff = nm.fx_quantize(dy32, cfg.bwd_acc_bits) - dot
    return nm.log_mul(diff, s32, cfg.mant_bits, half_range=True).to(cfg.dtype)


def _off_fast_rows(s, dy, cfg):
    """Rows the backward's warp kernel sends to its exact int64 route by the
    range checks its docstring in csrc/hyft_softmax.cu states: dy's and s's
    largest exponents together past 277 - bwd_acc, s or |dy| out of range,
    a nonzero s or dy below 2**-53, or |dot| at 2**(mant - 1) or more."""
    from repro_torch.core import numerics as nm
    mant = cfg.mant_bits
    a = dy.float().abs().view(torch.int32)
    b = s.float().view(torch.int32)
    ea, eb = (a >> 23).amax(-1), (b >> 23).amax(-1)
    tiny = (((a > 0) & (a < 74 << 23)) | ((b > 0) & (b < 74 << 23))).any(-1)
    p = nm.log_mul(dy.float(), s.float(), mant, half_range=True)
    units = torch.floor(p * 2.0 ** cfg.bwd_acc_bits).to(torch.int64).sum(-1)
    big_dot = units.abs().to(torch.float32) * 2.0 ** -cfg.bwd_acc_bits >= 2.0 ** (mant - 1)
    return ((ea + eb > 277 - cfg.bwd_acc_bits) | (ea > 126 + mant) | (eb > 127 + mant)
            | (b < 0).any(-1) | tiny | big_dot)


_OFF_RANGE = [(case, dtype) for case in ("dy1e4_hyft32", "count_2p24_hyft32",
                                         "dot_past_cap_hyft16", "tiny_hyft16")
              for dtype in (torch.float32, torch.float16, torch.bfloat16)
              if not (case == "tiny_hyft16" and dtype == torch.float16)]


@pytest.mark.gpu
@pytest.mark.parametrize("case,dtype", _OFF_RANGE,
                         ids=[f"{c}-{str(d)[6:]}" for c, d in _OFF_RANGE])
@pytest.mark.parametrize("shape", [(2112, 1024), (2113, 1057)])
def test_softmax_bwd_rows_off_the_fast_range_stay_exact(shape, case, dtype):
    """Rows the backward's warp path cannot take on its fast route go through
    its exact int64 route and stay bitwise: dy scaled by 1e4 under HYFT32
    (counts up to 2**30, rows past the sum precondition, held to the
    exact-sum reference); rows of one key with dy = 256 under HYFT32 (a
    count of exactly 2**24, within the precondition, held to the plain
    version); dy near 900 under HYFT16 (|dot| past 2**9); and every seventh
    dy scaled by 2**-60 (fp32 and bf16 hold it; fp16 rounds it to 0).  Both
    dz types.  A row within EXACT_UNITS cannot overflow an int32 lane sum
    (its every partial sum is at most 2**24), so the 1e4 rows lie past
    it."""
    from repro_torch.core.hyft import HYFT16, HYFT32
    from repro_torch.kernels import hyft_softmax as hs
    gen = _card()
    cfg = HYFT16 if case.endswith("hyft16") else HYFT32
    z, dy = _softmax_case(gen, shape, 3.0, dtype)
    s = hs.hyft_softmax_fwd_kernel(z, cfg).to(dtype)
    if case == "dy1e4_hyft32":
        dy = (dy * 1e4).clamp(-6e4, 6e4)
    elif case == "count_2p24_hyft32":
        s = torch.zeros_like(s)
        s[:, 0] = 1.0
        dy = torch.full_like(dy, 256.0)
    elif case == "dot_past_cap_hyft16":
        dy = 900.0 + dy
    else:
        dy[:, ::7] *= 2.0 ** -60
    dy = dy.to(dtype)
    assert bool(_off_fast_rows(s, dy, cfg).float().mean() > 0.5)
    dz = hs.hyft_softmax_bwd_kernel(s, dy, cfg)
    assert torch.equal(dz, _bwd_exact_sum(s, dy, cfg))
    units = hs.bwd_sum_units(s, dy, cfg)
    if case != "dy1e4_hyft32":
        assert int(units.max()) <= hs.EXACT_UNITS
        assert torch.equal(dz, hs.hyft_softmax_bwd(s, dy, cfg))
    else:
        assert bool((units > hs.EXACT_UNITS).float().mean() > 0.5)
    dz32 = hs.hyft_softmax_bwd_kernel(s, dy, cfg, out_dtype=torch.float32)
    assert torch.equal(dz32, dz.float())


@pytest.mark.gpu
def test_softmax_kernels_reject_bad_input():
    from repro_torch.kernels import hyft_softmax as hs
    _card()
    z = torch.zeros(4, 8, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        hs.hyft_softmax_fwd_kernel(z.double(), HYFT16)
    with pytest.raises(ValueError, match="last axis"):
        hs.hyft_softmax_fwd_kernel(z[:, :0], HYFT16)
    with pytest.raises(ValueError, match="shape"):
        hs.hyft_softmax_bwd_kernel(z, z[:, :4], HYFT16)
    with pytest.raises(ValueError, match="on cpu"):
        hs.hyft_softmax_bwd_kernel(z, z.cpu(), HYFT16)
    with pytest.raises(ValueError, match="block_rows"):
        hs.hyft_softmax_bwd_kernel(z, z, HYFT16, block_rows=0)
    with pytest.raises(RuntimeError, match="cudaError"):     # refused by the C entry
        fa._launch("hyft_softmax_fwd", z.device, fa._ptr(z), fa._ptr(z), 7, 0, 4, 8,
                   *fa._hyft_args(HYFT16), counts=hs.LAUNCHES)   # no input type 7


def _unfused_model():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model
    return build_model(smoke_config(get_config("qwen2-1.5b")).with_(
        softmax_impl="hyft16_kernel", attn_mode="unfused"))


@pytest.mark.gpu
def test_unfused_training_step_launches_the_softmax_kernels():
    """One training step of a 2-layer model in the unfused mode with the
    kernel softmax, remat "full": the forward kernel twice per layer, the
    backward kernel once, no attention kernel; the same loss and gradient
    bits as the plain hyft16 softmax on the card."""
    from repro_torch import optim
    from repro_torch.configs import TrainConfig
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.kernels import hyft_softmax as hs
    from repro_torch.models import build_model
    from repro_torch.train.step import grads_of, make_loss_fn, make_step_fn
    from repro_torch.train.state import init_state

    _card()
    model = _unfused_model()
    ocfg = optim.OptConfig(lr=1e-3)
    state = init_state(model, ocfg, 0, device="cuda")
    batch = lm_batch(DataConfig(vocab=model.cfg.vocab, seq_len=96, global_batch=2), 0,
                     device="cuda")
    tcfg = TrainConfig(warmup_steps=0, total_steps=4, remat="full")
    grads = {}
    for impl in ("hyft16", "hyft16_kernel"):
        m = build_model(model.cfg.with_(softmax_impl=impl))
        grads[impl] = grads_of(make_loss_fn(m, tcfg), state["params"], batch)
    (lh, _, gh), (lk, _, gk) = grads["hyft16"], grads["hyft16_kernel"]
    assert torch.equal(lh, lk)
    for a, b in zip(tree_leaves(gh), tree_leaves(gk)):
        assert torch.equal(a, b)
    for counts in (hs.LAUNCHES, fa.LAUNCHES):
        for name in counts:
            counts[name] = 0
    state, metrics = make_step_fn(model, tcfg, ocfg)(state, batch)
    torch.cuda.synchronize()
    n = model.cfg.n_layers
    assert hs.LAUNCHES == {"hyft_softmax_fwd": 2 * n, "hyft_softmax_bwd": n}
    assert not any(fa.LAUNCHES.values())
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


@pytest.mark.gpu
def test_unfused_generate_launches_the_forward_kernel_only():
    """Greedy generate in the unfused mode with the kernel softmax: one
    forward launch per layer for the prompt and per decode step, no
    backward and no attention kernel."""
    from repro_torch.configs import ServeConfig
    from repro_torch.kernels import hyft_softmax as hs
    from repro_torch.serve.engine import generate

    gen = _card()
    model = _unfused_model()
    params = model.init(0)
    tokens = torch.randint(0, model.cfg.vocab, (2, 12), generator=gen, device="cuda",
                           dtype=torch.int32)
    for counts in (hs.LAUNCHES, fa.LAUNCHES):
        for name in counts:
            counts[name] = 0
    out = generate(model, params, {"tokens": tokens},
                   ServeConfig(max_len=24, cache_dtype="fp2fx8", attn_mode="unfused"),
                   max_new=6)
    torch.cuda.synchronize()
    n = model.cfg.n_layers
    assert hs.LAUNCHES == {"hyft_softmax_fwd": n * 6, "hyft_softmax_bwd": 0}
    assert not any(fa.LAUNCHES.values())
    assert out.shape == (2, 6)



# --------------------------------------------------------------------------
# non-finite inputs: a NaN score is FP2FX raw 0 (as XLA's convert makes
# it), a NaN or Inf V reaches the PV products
# --------------------------------------------------------------------------


def _poison(k, v, sc, target, index):
    """Write NaN in place into K or V at ``index`` (every column), or into
    its fp2fx8 scale, which holds the fp32 value of an int8 row."""
    if f"{target}_scale" in sc:
        sc[f"{target}_scale"][index] = float("nan")
    else:
        (k if target == "k" else v)[index] = float("nan")


def _hold_poisoned(got, ref, cfg, v_absmax, hit):
    """A kernel's output on poisoned K/V against its plain version's stats.
    Non-finite in exactly the same rows; each ``hit`` row (one that sees a
    poisoned V) out of range in both, non-finite or past ``v_absmax`` (the
    Hyft divide reads a NaN sum's all-ones exponent as a number, so a hit
    row may be finite garbage, as in JAX); every other row finite and
    within the ``out`` bound of ``out_errors``."""
    out_r = fa._splitk_combine(*ref, cfg)
    bad = ~torch.isfinite(got).all(-1)
    assert torch.equal(bad, ~torch.isfinite(out_r).all(-1))
    for out in (got, out_r):
        wild = ~torch.isfinite(out).all(-1) | (out.abs().amax(-1) > v_absmax)
        assert torch.equal(wild & hit, hit)
    assert not (bad & ~hit).any()
    acc, m, l = ref
    ref = (torch.where(hit[:, None, :, None], 0.0, acc), m, l)
    err = fa.out_errors(torch.where(hit[..., None], 0.0, got), ref, cfg, v_absmax)
    assert err["out"] <= 1, err


_POISON_CASES = [(kind, target) for kind in ("decode", "verify", "paged_decode",
                                             "paged_verify") for target in ("v", "k")]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [HYFT16, HYFT32], ids=["hyft16", "hyft32"])
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8", "bfloat16"])
@pytest.mark.parametrize("kind,target", _POISON_CASES,
                         ids=[f"{k}-{t}" for k, t in _POISON_CASES])
def test_attention_kernels_on_poisoned_kv(kind, target, cache_dtype, cfg):
    """Kernels 6-9 with a NaN at one live key of sequence 1, KV head 0 (a
    whole K or V row, or its fp2fx8 scale) against their plain versions
    (``_hold_poisoned``).  V: every query row of that (sequence, head)
    sees the key and goes out of range in both, the same rows non-finite
    in both, no other row moved.  K alone: the NaN score is raw 0, so every
    row stays finite, within the bound."""
    gen = _card()
    sq = 5 if kind.endswith("verify") else None
    if kind.startswith("paged"):
        ps = 16
        k, v, sc, vf, bt, mask, lengths = _paged(gen, ps, cache_dtype)
        vmax = float(vf.abs().max())
        _poison(k, v, sc, target, (int(bt[1, 0]), 0, 3))
        if sq is not None:
            mask = (torch.arange(NB * ps, device="cuda")[None, None]
                    <= (lengths - sq)[:, None, None]
                    + torch.arange(sq, device="cuda")[None, :, None]).float().contiguous()
        q3 = torch.randn(B * HKV, HQ // HKV * (sq or 1), D, generator=gen, device="cuda")
        kw = dict(cfg=cfg, sm_scale=D ** -0.5, hkv=HKV, sq=sq)
        args = (q3, k, v, sc.get("k_scale"), sc.get("v_scale"), bt, mask)
        got = fa._paged_attention_cuda(*args, **kw)
        ref = fa.paged_tiles_plain(*args, **kw)
    else:
        Sk = 600
        k, v, sc, vf = _kv(gen, Sk, cache_dtype)
        vmax = float(vf.abs().max())
        _poison(k, v, sc, target, (1, 0, 3))
        if sq is None:
            mask = (torch.arange(Sk, device="cuda")[None]
                    < torch.tensor([Sk, Sk // 3 + 1], device="cuda")[:, None]).float()
        else:
            start = torch.tensor([Sk - sq, Sk // 3], device="cuda")
            mask = (torch.arange(Sk, device="cuda")[None, None]
                    <= start[:, None, None]
                    + torch.arange(sq, device="cuda")[None, :, None]).float()
        q3 = torch.randn(B * HKV, HQ // HKV * (sq or 1), D, generator=gen, device="cuda")
        flat = [t.reshape(-1, Sk, *t.shape[3:]) if t is not None else None
                for t in (k, v, sc.get("k_scale"), sc.get("v_scale"))]
        kw = dict(cfg=cfg, sm_scale=D ** -0.5, bk=fa._block_k(Sk, 256), hkv=HKV, sq=sq)
        got = fa._splitk_attention_cuda(q3, *flat, mask, **kw)
        ref = fa.splitk_tiles_plain(q3, *flat, mask, **kw)
    hit = torch.zeros(got.shape[:2], dtype=torch.bool, device="cuda")
    if target == "v":
        hit[HKV] = True                   # sequence 1, head 0: every row
    _hold_poisoned(got, ref, cfg, vmax, hit)


_NAN_SOFTMAX = [(cfg, dtype) for cfg in ("hyft16", "hyft32")
                for dtype in (torch.float32, torch.float16, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(37, 200), (2113, 1024)], ids=["block", "warp"])
@pytest.mark.parametrize("cfg,dtype", _NAN_SOFTMAX,
                         ids=[f"{c}-{str(d)[6:]}" for c, d in _NAN_SOFTMAX])
def test_softmax_kernels_on_rows_holding_nan(cfg, dtype, shape):
    """Kernels 1-2 on rows holding a NaN against their plain versions, as
    ``test_softmax_kernels_match_plain`` holds them: bit for bit in every
    row within the sum precondition (all of them under HYFT16; NaN bits
    included), the forward within ``softmax_errors`` past it (HYFT32).
    Forward: a NaN score at key 0 of every third row and whole NaN rows,
    each read as raw 0.  Backward: NaN dy at each
    third row's most probable key, whole NaN rows, and +inf dy at every
    fifth row's most probable key: such an element's count is infinite
    (log_mul reads the all-ones exponent), the dot +-inf or NaN as the
    plain version's fp32 sum makes it, and the row leaves the warp
    kernel's fast route.  The block path (37 rows) and the warp path
    (2113 rows)."""
    from repro_torch.kernels import hyft_softmax as hs
    cfg = HYFT16 if cfg == "hyft16" else HYFT32
    gen = _card()
    z, dy = _softmax_case(gen, shape, 3.0, dtype)
    rows = z.view(-1, shape[-1])
    rows[::3, 0] = float("nan")
    rows[1::7] = float("nan")
    s = hs.hyft_softmax_fwd_kernel(z, cfg)
    ref = hs.hyft_softmax_fwd(z, cfg)
    err = hs.softmax_errors(s, ref, hs.fwd_sum_units(z, cfg), cfg)
    assert torch.isfinite(s).all() and err["mismatches"] == 0 and err["past_ratio"] <= 1, err
    if cfg.io_dtype == "float16":
        assert torch.equal(s, ref)
    dy = dy.to(s.dtype)
    top = s.view(-1, shape[-1]).float().argmax(-1)
    drow = dy.view(-1, shape[-1])
    r = torch.arange(drow.shape[0], device="cuda")
    drow[r[::3], top[::3]] = float("nan")
    drow[r[2::5], top[2::5]] = float("inf")
    drow[1::7] = float("nan")
    finite = torch.isfinite(drow).all(-1)
    assert int(hs.bwd_sum_units(s, dy, cfg)[finite].max()) <= hs.EXACT_UNITS
    bits = torch.int16 if cfg.dtype != torch.float32 else torch.int32
    for out_dtype in (None, torch.float32):
        dz = hs.hyft_softmax_bwd_kernel(s, dy, cfg, out_dtype=out_dtype)
        plain = hs.hyft_softmax_bwd(s, dy, cfg).to(dz.dtype)
        b = bits if dz.dtype == cfg.dtype else torch.int32
        assert torch.equal(dz.view(b), plain.view(b))


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
@pytest.mark.parametrize("kind", ["decode", "paged_decode", "paged_verify"])
def test_attention_kernels_weigh_masked_keys_like_plain(kind, cache_dtype):
    """A NaN V at a key past sequence 1's length (contiguous: key Sk - 1;
    paged: the null page, where the block table's unused entries point):
    the kernels, like their plain versions and JAX's kernels, weigh a
    masked key by a probability that is not 0, so every row of that
    sequence and head goes out of range in both (``_hold_poisoned``), and
    no other row.  This is how a poisoned slot's masked writes reach every
    slot through the null page (ROADMAP queue 3)."""
    gen = _card()
    cfg = HYFT16
    sq = 5 if kind == "paged_verify" else None
    if kind.startswith("paged"):
        ps = 16
        k, v, sc, vf, bt, mask, lengths = _paged(gen, ps, cache_dtype)
        index = (0, 0, 3)                                   # the null page
        if sq is not None:
            mask = (torch.arange(NB * ps, device="cuda")[None, None]
                    <= (lengths - sq)[:, None, None]
                    + torch.arange(sq, device="cuda")[None, :, None]).float().contiguous()
        q3 = torch.randn(B * HKV, HQ // HKV * (sq or 1), D, generator=gen, device="cuda")
        kw = dict(cfg=cfg, sm_scale=D ** -0.5, hkv=HKV, sq=sq)

        def run(fn):
            return fn(q3, k, v, sc.get("k_scale"), sc.get("v_scale"), bt, mask, **kw)
        kernel, plain = fa._paged_attention_cuda, fa.paged_tiles_plain
    else:
        Sk = 600
        k, v, sc, vf = _kv(gen, Sk, cache_dtype)
        index = (1, 0, Sk - 1)
        mask = (torch.arange(Sk, device="cuda")[None]
                < torch.tensor([Sk, Sk // 3 + 1], device="cuda")[:, None]).float()
        q3 = torch.randn(B * HKV, HQ // HKV, D, generator=gen, device="cuda")
        kw = dict(cfg=cfg, sm_scale=D ** -0.5, bk=fa._block_k(Sk, 256), hkv=HKV, sq=None)

        def run(fn):
            flat = [t.reshape(-1, Sk, *t.shape[3:]) if t is not None else None
                    for t in (k, v, sc.get("k_scale"), sc.get("v_scale"))]
            return fn(q3, *flat, mask, **kw)
        kernel, plain = fa._splitk_attention_cuda, fa.splitk_tiles_plain
    vmax = float(vf.abs().max())
    _poison(k, v, sc, "v", index)
    hit = torch.zeros(q3.shape[:2], dtype=torch.bool, device="cuda")
    hit[HKV] = True
    _hold_poisoned(run(kernel), run(plain), cfg, vmax, hit)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", ["hyft16", "hyft32"])
@pytest.mark.parametrize("shape", [(4096, 16), (4096, 8), (8, 16)],
                         ids=["phi-prefill", "grok-prefill", "phi-decode"])
def test_softmax_kernels_at_router_shapes(shape, cfg):
    """Kernels 1-2 on the MoE router's rows (one a token, one column an
    expert; fp32 scores in, as ``models/moe.py`` calls them): 4096 rows
    take the warp path, 8 the block path.  Every row is full; rows 1 mod 4
    hold values on a grid of 1/2 (equal scores: probabilities that tie),
    rows 2 mod 4 are nearly flat (every score one raw: all tie), rows 3 mod
    5 hold a NaN at key 0 and rows 7 mod 11 are NaN throughout.  The
    forward bit for bit in every row within the sum precondition (HYFT16:
    all), within ``softmax_errors`` past it; the backward on fp16 dy (the
    training step's cast of the router's fp32 dy), with NaN dy at rows 0
    mod 6, bit for bit in its own type and as fp32."""
    from repro_torch.kernels import hyft_softmax as hs
    cfg = HYFT16 if cfg == "hyft16" else HYFT32
    gen = _card()
    z = torch.randn(shape, generator=gen, device="cuda") * 3
    z[1::4] = torch.round(z[1::4] * 2) / 2
    z[2::4] = z[2::4] * 1e-4
    z[3::5, 0] = float("nan")
    z[7::11] = float("nan")
    s = hs.hyft_softmax_fwd_kernel(z, cfg)
    ref = hs.hyft_softmax_fwd(z, cfg)
    err = hs.softmax_errors(s, ref, hs.fwd_sum_units(z, cfg), cfg)
    assert err["mismatches"] == 0 and err["past_ratio"] <= 1, err
    if cfg.io_dtype == "float16":
        assert torch.equal(s, ref)
    ties = s[1::4].float()
    assert (ties.sort(-1).values.diff(dim=-1) == 0).any(), "no tied probabilities"
    dy = torch.randn(shape, generator=gen, device="cuda").to(s.dtype)
    dy[::6, 1] = float("nan")
    finite = torch.isfinite(dy).all(-1)
    assert int(hs.bwd_sum_units(s, dy, cfg)[finite].max()) <= hs.EXACT_UNITS
    bits = torch.int16 if cfg.dtype != torch.float32 else torch.int32
    for out_dtype in (None, torch.float32):
        dz = hs.hyft_softmax_bwd_kernel(s, dy, cfg, out_dtype=out_dtype)
        plain = hs.hyft_softmax_bwd(s, dy, cfg).to(dz.dtype)
        b = bits if dz.dtype == cfg.dtype else torch.int32
        assert torch.equal(dz.view(b), plain.view(b))
