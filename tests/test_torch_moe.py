"""The port's MoE family against the JAX package's, on the CPU.

phi3.5-moe-42b-a6.6b's smoke config (2 layers, d_model 64, 4 / 4 heads of
16, 4 experts top-2, groups of 16 tokens, LayerNorm, silu) and grok-1's
(rms, gelu, here with 8 experts), vocab 64, fp32 compute: the JAX weights
go through the weights bridge, and the same tokens go through both
packages.  Kernel mode runs the JAX package's Pallas kernels in interpret
mode and the port's plain versions of its CUDA kernels.  The reference
``moe_apply`` hands ``jax.nn.one_hot`` a float slot index, which
``pytest.ini`` turns into an error (ROADMAP queue 3); the tests that call
it filter that one warning, and change no setting.

What can go wrong where torch differs from JAX, each named in a test:
  * ties in top-k: ``jax.lax.top_k`` takes the lower index first,
    ``torch.topk`` promises no order (``test_top_k_keeps_the_lower_index_
    among_ties``; Hyft16's coarse probabilities tie in the routing tests);
  * the one-hot of a slot of -1 or past capacity is a zero row
    (``test_route_slots_and_capacity_match_the_reference``, with capacity
    binding);
  * slot order and capacity: token-major, choice-minor counts over groups
    (the same test, on the same probabilities fed to both);
  * dispatch and combine: the reference's dense one-hot products
    (``test_moe_apply_matches_jax``: grid inputs make the router logits
    exact in any summation order, so both packages route alike);
  * near-ties across the packages: the router logits are fp32 sums in
    another order, and one moved FP2FX raw can swap two experts.  Tests
    through whole blocks assert their data's margin first
    (``_assert_router_margin``: every token's top-k survives a move of one
    raw of every router logit against it, on the port's logits, which lie
    within ~1e-6 of JAX's), as the HYFT32 tests assert their adder-tree
    precondition.

Tolerances: hidden states and logits within 1e-4 of their largest
(``tests/test_torch_generate.py``'s); the loss within 1e-5 relative and
each gradient leaf within 1e-3 of its largest |g| (``tests/test_torch_
train.py``'s); ``moe_apply`` on exact router logits within 1e-5 of the
output's largest (only the experts' products differ in order), its aux
within 1e-6 relative; routing decisions exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.core.registry import get_softmax as jax_get_softmax
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.layers import unbox
from repro.serve import scheduler as jsched
from repro_torch.configs import ServeConfig, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.registry import get_softmax, hyft_config_for
from repro_torch.models import build_model, transformer
from repro_torch.models import moe as tmoe
from repro_torch.serve import scheduler as tsched
from repro_torch.train.step import grads_of
from repro_torch.tree import tree_leaves

PHI, GROK = "phi3.5-moe-42b-a6.6b", "grok-1-314b"
RTOL, LOSS_RTOL, GRAD_TOL, MOE_RTOL = 1e-4, 1e-5, 1e-3, 1e-5
ONE_HOT = pytest.mark.filterwarnings("ignore:jax.nn.one_hot input should be integer-typed")
pytestmark = ONE_HOT


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


class _CopyingJnp:
    """``jax.numpy`` with an ``asarray`` that always copies its input (the
    JAX scheduler's host mirrors, ROADMAP queue 3)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x):
        return jnp.array(x, copy=True)


def _configs(arch, **kw):
    kw = dict(dict(vocab=64, compute_dtype="float32"), **kw)
    return (jax_smoke_config(jax_get_config(arch)).with_(**kw),
            smoke_config(get_config(arch)).with_(**kw))


def _weights(jcfg, seed=0, router_scale=1.0):
    """JAX's init and its bridge to the port.  ``router_scale`` multiplies
    the router's weights in both: the whole-model tests take 4, which
    spreads the router logits so that the data meets the margin
    precondition (``_assert_router_margin``; at 1, one token of 192 in
    grok's smoke forward lies within a raw)."""
    jparams = unbox(jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))
    if router_scale != 1.0:
        moe = jparams["blocks"]["moe"]
        jparams["blocks"]["moe"] = dict(moe, router=moe["router"] * router_scale)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _record_router(monkeypatch):
    """Every router call's fp32 logits in the port, with its softmax."""
    seen, orig = [], tmoe.get_softmax

    def get(name):
        fn = orig(name)

        def record(z):
            seen.append((z.detach().clone(), name))
            return fn(z)
        return record
    monkeypatch.setattr(tmoe, "get_softmax", get)
    return seen


def _assert_router_margin(seen, k):
    """The precondition of a comparison through whole blocks: each token's
    top-k set survives a move of one FP2FX raw (2**-frac_bits; 2**-16 for a
    softmax without one) of every router logit against it, the chosen
    experts' down and the others' up."""
    assert seen
    for z, name in seen:
        cfg = hyft_config_for(name)
        raw = 2.0 ** -(cfg.frac_bits if cfg else 16)
        sm = get_softmax(name)
        _, idx = tmoe.top_k(sm(z).float(), k)
        chosen = F.one_hot(idx, z.shape[-1]).sum(-2).bool()
        _, moved = tmoe.top_k(sm(z + torch.where(chosen, -raw, raw)).float(), k)
        assert torch.equal(idx.sort(-1).values, moved.sort(-1).values), \
            "the data's router margin is within one raw"


def _close(want, got, rtol=RTOL):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


# --------------------------------------------------------------------------
# moe_init, top-k, routing, moe_apply
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [PHI, GROK])
def test_moe_init_matches_jax(arch):
    """The same keys, shapes and dtypes as JAX's ``moe_init`` (fp32 router
    at bf16 params), and each leaf's spread within 5% of JAX's scale: the
    router ``dm ** -0.5``, the up and gate products ``E ** -0.5`` (JAX's
    ``param`` takes the first axis as the fan-in), ``w_down`` ``dff **
    -0.5``; stacked per layer by the transformer's init."""
    cfg = get_config(arch).with_(d_model=64, d_ff=96, n_layers=3, vocab=64, n_heads=4,
                                 n_kv_heads=2, d_head=16)
    want = unbox(jmoe.moe_init(jax.random.PRNGKey(0), cfg, jnp.bfloat16))
    got = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    assert sorted(got) == sorted(want)
    E, dm, dff = cfg.n_experts, cfg.d_model, cfg.d_ff
    scale = {"router": dm ** -0.5, "w_up": E ** -0.5, "w_gate": E ** -0.5,
             "w_down": dff ** -0.5}
    for name, w in want.items():
        t = got[name]
        assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == str(w.dtype), name
        assert abs(float(t.float().std()) / scale[name] - 1) < 0.05, name
        assert abs(float(np.asarray(w, np.float32).std()) / scale[name] - 1) < 0.05, name
    stacked = transformer.init(torch.Generator().manual_seed(0), cfg, "cpu")["blocks"]
    assert "mlp" not in stacked
    for name, w in want.items():
        assert tuple(stacked["moe"][name].shape) == (3,) + w.shape


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_keeps_the_lower_index_among_ties(k):
    """Rows drawn from three values, so most hold ties at the k-th place:
    values and indices equal ``jax.lax.top_k``'s, which takes the lower
    index first."""
    rng = np.random.default_rng(k)
    probs = rng.choice(np.array([0.125, 0.25, 0.5], np.float32), (64, 8))
    wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
    gv, gi = tmoe.top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    srt = np.sort(probs, -1)[:, ::-1]
    assert (srt[:, k - 1] == srt[:, k]).mean() > 0.5


def _reference_routing(probs, k, cap):
    """The reference's routing lines (``repro/models/moe.py:55-63``) on the
    given probabilities: keep (ng, G, k, E) and slot (ng, G, k, E, cap)."""
    probs = jnp.asarray(probs)
    ng, G, E = probs.shape
    _, gate_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(ng, G * k, E), axis=1).reshape(ng, G, k, E)
    pos = pos * onehot - 1.0
    keep = (pos >= 0) & (pos < cap)
    slot = jax.nn.one_hot(jnp.where(keep, pos, -1), cap, dtype=jnp.float32)
    return np.asarray(keep), np.asarray(slot)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_route_slots_and_capacity_match_the_reference(capacity_factor, monkeypatch):
    """The same router probabilities fed to the port's ``_route`` and to the
    reference's lines: the kept (token, choice) pairs and every capacity
    slot's one-hot equal, slot -1 (not chosen, or past capacity) a zero
    row.  Probabilities from a coarse grid, so the k-th place ties often.
    At capacity factor 0.5 capacity binds: choices are dropped (at 1.25
    too, where an expert draws more than its share)."""
    cfg = get_config(PHI).with_(n_experts=8, moe_top_k=2, capacity_factor=capacity_factor)
    ng, G = 3, 32
    cap = tmoe.capacity(cfg, G)
    rng = np.random.default_rng(7)
    probs = rng.integers(1, 6, (ng, G, cfg.n_experts)).astype(np.float32) / 8
    monkeypatch.setattr(tmoe, "get_softmax",
                        lambda name: lambda z: torch.from_numpy(probs))
    x = torch.zeros(ng, G, cfg.d_model)
    p = {"router": torch.zeros(cfg.d_model, cfg.n_experts)}
    _, _, onehot, keep, slot = tmoe._route(p, x, cfg)
    want_keep, want_slot = _reference_routing(probs, cfg.moe_top_k, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    dropped = int(onehot.sum()) - int(keep.sum())
    assert dropped > 0 or capacity_factor > 1
    assert int(slot.sum()) == int(keep.sum())     # one slot per kept choice


def _grid_inputs(cfg, seed):
    """Inputs whose router logits are exact in any summation order: x on a
    grid of 1/4 in [-1, 1], the router on a grid of 1/64 (every partial sum
    a multiple of 2**-8 far below 2**24 of them)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (2, 24, cfg.d_model)).astype(np.float32) / 4
    router = rng.integers(-8, 9, (cfg.d_model, cfg.n_experts)).astype(np.float32) / 64
    return x, router


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("impl", ["hyft16", "hyft16_kernel", "exact"])
def test_moe_apply_matches_jax(impl, capacity_factor):
    """``moe_apply`` on the same weights and inputs: the output, the aux
    loss, and the number of dropped (token, choice) pairs (the reference's
    lines on JAX's own probabilities).  The grid inputs make the router
    logits equal in both packages, so both route alike; Hyft16's
    probabilities tie on them, the exact softmax's rarely."""
    jcfg, tcfg = _configs(PHI, softmax_impl=impl, capacity_factor=capacity_factor)
    jparams, _ = _weights(jcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    x, router = _grid_inputs(jcfg, 1)
    jp = dict(jp, router=jnp.asarray(router))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    want, want_aux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    _close(want, got.numpy(), MOE_RTOL)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    G = tcfg.moe_group
    xg = torch.from_numpy(x).reshape(-1, G, tcfg.d_model)
    probs, _, onehot, keep, _ = tmoe._route(tp, xg, tcfg)
    jlogits = jnp.einsum("bsd,de->bse", jnp.asarray(x).reshape(-1, G, 64), jnp.asarray(router))
    jprobs = jax_get_softmax(impl)(jlogits).astype(jnp.float32)
    want_keep, _ = _reference_routing(jprobs, tcfg.moe_top_k, tmoe.capacity(tcfg, G))
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    dropped = int(onehot.sum()) - int(keep.sum())
    assert dropped > 0 or capacity_factor > 1


# --------------------------------------------------------------------------
# the model: lm_loss and its gradients, prefill and decode, the engine
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def phi():
    """phi3.5-moe smoke, hyft16_kernel (the router through kernel 1's plain
    version, its backward kernel 2's), kernel mode; JAX weights bridged,
    the router's x4 (``_weights``); one batch; JAX's loss and gradients
    (remat "none")."""
    jcfg, tcfg = _configs(PHI, softmax_impl="hyft16_kernel", attn_mode="kernel")
    jparams, tparams = _weights(jcfg, router_scale=4.0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((2, 32), np.float32)}
    jm = jax_build_model(jcfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch), remat="none"),
        has_aux=True))(jparams)
    ref = (float(loss), float(metrics["aux"]), jax.tree.map(np.asarray, grads))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, tcfg, jparams, tparams, tbatch, ref


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_loss_and_grads_match_jax(phi, remat, monkeypatch):
    """lm_loss (with the summed aux) and every gradient leaf, the router's
    included (through kernel 2's plain version), under each remat policy;
    the three policies give the same bits."""
    _, tcfg, _, tparams, tbatch, (want_loss, want_aux, want_grads) = phi
    seen = _record_router(monkeypatch)
    model = build_model(tcfg)
    runs = {}
    for policy in ("none", remat):
        loss, metrics, grads = grads_of(
            lambda p, b: model.loss(p, b, remat=policy), tparams, tbatch)
        runs[policy] = (loss, grads)
    _assert_router_margin(seen, tcfg.moe_top_k)
    loss, grads = runs[remat]
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert abs(float(metrics["aux"]) - want_aux) <= LOSS_RTOL * abs(want_aux)
    assert float(metrics["aux"]) > 0
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(want_grads)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(w).max()))
    assert float(grads["blocks"]["moe"]["router"].abs().max()) > 0
    assert torch.equal(runs["none"][0], loss)
    for a, b in zip(tree_leaves(runs["none"][1]), tree_leaves(grads)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_and_decode_match_jax(phi, layout, attn_mode, monkeypatch):
    """prefill_chunk of ragged prompts (16 lanes, one dispatch group: the
    padded lanes compete for capacity, as in the reference), then one
    decode_step: logits within RTOL, over the dense cache or pages of 4
    through a shuffled block table."""
    jcfg, tcfg, jparams, tparams, *_ = phi
    jcfg, tcfg = jcfg.with_(attn_mode=attn_mode), tcfg.with_(attn_mode=attn_mode)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    seen = _record_router(monkeypatch)
    toks = np.random.default_rng(5).integers(0, 64, (2, 8)).astype(np.int32)
    lengths = np.array([8, 5], np.int32)
    ps, nb = 4, 4
    if layout == "dense":
        jc = jm.init_cache(jparams, 2, ps * nb, "float32")
        tc = tm.init_cache(tparams, 2, ps * nb, "float32", device="cpu")
    else:
        table = np.array([[5, 2, 7, 1], [3, 8, 6, 4]], np.int32)
        jc = dict(jm.init_paged_cache(jparams, 2 * nb, ps, "float32"),
                  block_tables=jnp.asarray(table))
        tc = dict(tm.init_paged_cache(tparams, 2 * nb, ps, "float32", device="cpu"),
                  block_tables=torch.from_numpy(table))
    jl, jc = jm.prefill_chunk(jparams, jc, jnp.asarray(toks), jnp.zeros((2,), jnp.int32),
                              lengths=jnp.asarray(lengths))
    with torch.no_grad():
        tl, tc = tm.prefill_chunk(tparams, tc, torch.from_numpy(toks),
                                  torch.zeros(2, dtype=torch.int32),
                                  lengths=torch.from_numpy(lengths))
    for b, n in enumerate(lengths):           # the padded lanes' logits are garbage
        _close(np.asarray(jl)[b, :n], tl.numpy()[b, :n])
    nxt = np.array([[3], [5]], np.int32)
    jl2, _ = jm.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(lengths))
    with torch.no_grad():
        tl2, _ = tm.decode_step(tparams, tc, torch.from_numpy(nxt), torch.from_numpy(lengths))
    _close(jl2, tl2.numpy())
    _assert_router_margin(seen, tcfg.moe_top_k)


def test_slot_pool_engine_matches_jax(phi, monkeypatch):
    """Continuous batching over pages of 4 (3 slots, bursts of 4, chunks of
    4, kernel mode, hyft16): the greedy tokens of 5 ragged requests equal
    the JAX engine's, whose ``jnp.asarray`` copies.  A burst's masked lanes
    and a chunk's padded lanes route with the live ones, in both."""
    jcfg, tcfg, jparams, tparams, *_ = phi
    jcfg, tcfg = jcfg.with_(softmax_impl="hyft16"), tcfg.with_(softmax_impl="hyft16")
    monkeypatch.setattr(jsched, "jnp", _CopyingJnp())
    seen = _record_router(monkeypatch)
    rng = np.random.default_rng(0)
    reqs = [dict(rid=i, tokens=rng.integers(0, 64, int(rng.integers(3, 9))).astype(np.int32),
                 max_new=int(rng.integers(3, 9))) for i in range(5)]
    kw = dict(max_len=32, cache_dtype="float32", scheduler="continuous", n_slots=3,
              decode_burst=4, attn_mode="kernel", kv_layout="paged", page_size=4,
              prefill_chunk=4, audit=True)
    jdone = jsched.SlotPoolEngine(jax_build_model(jcfg), jparams,
                                  JaxServeConfig(**kw)).run([jsched.Request(**r) for r in reqs])
    teng = tsched.SlotPoolEngine(build_model(tcfg), tparams, ServeConfig(**kw), device="cpu")
    tdone = teng.run([tsched.Request(**r) for r in reqs])
    _assert_router_margin(seen, tcfg.moe_top_k)
    assert sorted(tdone) == sorted(jdone) == list(range(5))
    for rid in jdone:
        assert tdone[rid].ok and tdone[rid].tokens == jdone[rid].tokens, rid
    assert len({t for c in tdone.values() for t in c.tokens}) > 3     # not one token
    assert teng.pool.pages_in_use == 0


@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
def test_grok_smoke_matches_jax(attn_mode, monkeypatch):
    """grok-1's smoke config (RMSNorm, tanh-gelu, here 8 experts top-2, the
    config's own HYFT32, as ``tests/test_torch_configs.py`` runs the dense
    configs): the hidden states of ``forward`` and the summed aux within
    RTOL of JAX's, and lm_loss within LOSS_RTOL."""
    jcfg, tcfg = _configs(GROK, attn_mode=attn_mode, n_experts=8)
    assert tcfg.softmax_impl == "hyft32"
    assert (tcfg.act, tcfg.norm, tcfg.n_experts, tcfg.moe_top_k) == ("gelu", "rms", 8, 2)
    jparams, tparams = _weights(jcfg, router_scale=4.0)
    seen = _record_router(monkeypatch)
    toks = np.random.default_rng(2).integers(0, 64, (2, 25)).astype(np.int32)
    want, want_aux = jtransformer.forward(jparams, toks[:, :24], jcfg, remat="none")
    with torch.no_grad():
        got, aux = transformer.forward(tparams, torch.from_numpy(toks[:, :24]), tcfg,
                                       remat="none")
    _assert_router_margin(seen, tcfg.moe_top_k)
    _close(want, got.numpy())
    assert abs(float(aux) - float(want_aux)) <= RTOL * abs(float(want_aux))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    wl, _ = jtransformer.lm_loss(jparams, jax.tree.map(jnp.asarray, batch), jcfg, remat="none")
    with torch.no_grad():
        tl, _ = transformer.lm_loss(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    tcfg, remat="none")
    assert abs(float(tl) - float(wl)) <= LOSS_RTOL * abs(float(wl))


def test_moe_models_build_through_the_zoo():
    """``build_model`` takes the MoE family, its paged cache too, and the
    zoo's ``init`` gives the JAX tree's keys (``blocks.moe``)."""
    cfg = smoke_config(get_config(PHI)).with_(vocab=64)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    assert sorted(params["blocks"]) == ["attn", "moe", "norms"]
    assert params["blocks"]["moe"]["router"].dtype == torch.float32
    cache = model.init_paged_cache(params, 6, 4, "fp2fx8", device="cpu")
    assert tuple(cache["blocks"]["k"].shape) == (cfg.n_layers, 7, cfg.n_kv_heads, 4,
                                                 cfg.d_head)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg.with_(family="rnn"))
