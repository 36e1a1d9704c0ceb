"""The port's speculative decoding against the JAX package's, on the CPU.

``repro_torch.serve.spec`` and the scheduler's ``spec`` mode against
``repro.serve.spec`` and the JAX ``SlotPoolEngine``, on the qwen2-1.5b smoke
model (hyft16, vocab 64, fp32 compute, ``attn_mode="kernel"``: Pallas in
interpret mode on the JAX side, the plain versions of the CUDA kernels on
the port's), the weights carried across by ``repro_torch.convert``.  The
block weights are scaled by 2: greedy decoding then repeats itself often
enough for n-gram drafts to be accepted, and not always, so both the
accepted and the rejected lanes are exercised.

Verification is exact, so a spec run must also emit the port's own
continuous scheduler's tokens.  As in ``tests/test_torch_scheduler.py``,
the JAX scheduler gets a ``jax.numpy`` whose ``asarray`` copies the host
mirrors it hands to asynchronously dispatched calls.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import build_model as jax_build_model
from repro.models.layers import unbox
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro.serve import spec as jspec
from repro_torch.configs import ServeConfig, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import spec as tspec

KW = dict(softmax_impl="hyft16", vocab=64, compute_dtype="float32", attn_mode="kernel")
SCALE = 2.0


class _CopyingJnp:
    """``jax.numpy`` with an ``asarray`` that always copies its input."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x):
        return jnp.array(x, copy=True)


@pytest.fixture(scope="module", autouse=True)
def _jax_scheduler_copies_host_mirrors():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsched, "jnp", _CopyingJnp())
        yield


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config(jax_get_config("qwen2-1.5b")).with_(**KW)
    jmodel = jax_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    jparams["blocks"] = jax.tree.map(lambda x: x * SCALE if x.ndim >= 3 else x,
                                     jparams["blocks"])
    tcfg = smoke_config(get_config("qwen2-1.5b")).with_(**KW)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def _requests(n, seed, max_new=(8, 14)):
    """Motif-tiled prompts (a 4-token motif three times, then 2 tokens):
    the n-gram drafter's regime."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        motif = rng.integers(0, 64, 4)
        toks = np.concatenate([np.tile(motif, 3), rng.integers(0, 64, 2)]).astype(np.int32)
        reqs.append(dict(rid=rid, tokens=toks, max_new=int(rng.integers(*max_new))))
    return reqs


def _scfg(**kw):
    return dict(dict(max_len=48, cache_dtype="float32", scheduler="spec", n_slots=2,
                     decode_burst=4, draft_k=4, attn_mode="kernel", audit=True), **kw)


def _run_port(setup, reqs, draft=None, **kw):
    _, _, tmodel, tparams = setup
    eng = tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(**_scfg(**kw)), device="cpu",
                                draft=draft)
    done = eng.run([tsched.Request(**r) for r in reqs])
    assert all(c.ok for c in done.values())
    return {rid: c.tokens for rid, c in done.items()}, eng


def _run_jax(setup, reqs, draft=None, **kw):
    jmodel, jparams, _, _ = setup
    eng = jsched.SlotPoolEngine(jmodel, jparams, JaxServeConfig(**_scfg(**kw)), draft=draft)
    done = eng.run([jsched.Request(**r) for r in reqs])
    return {rid: c.tokens for rid, c in done.items()}, eng


SPEC_STATS = ["spec_steps", "draft_tokens", "accepted_tokens", "tokens_emitted",
              "model_calls", "admitted", "prefills"]


# --------------------------------------------------------------------------
# the n-gram drafter
# --------------------------------------------------------------------------


def _context(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 6, int(rng.integers(0, 40))).astype(np.int32)
    motif = rng.integers(0, 64, int(rng.integers(2, 6)))
    return np.concatenate([np.tile(motif, int(rng.integers(1, 5))),
                           rng.integers(0, 64, int(rng.integers(0, 3)))]).astype(np.int32)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["random", "motif"])
def test_ngram_drafter_matches_jax(kind, seed):
    """``NgramDrafter.draft`` and ``draft_batch`` give JAX's drafts for every
    draft length and n-gram bound, on random and motif-tiled contexts."""
    ctx = _context(kind, seed)
    for nmax in (1, 3, 5):
        td, jd = tspec.NgramDrafter(nmax), jspec.NgramDrafter(nmax)
        for k in range(6):
            assert td.draft(ctx, k).tolist() == jd.draft(ctx, k).tolist(), (nmax, k)
    contexts = [ctx, None, _context(kind, seed + 100), ctx[:3]]
    want = np.array([4, 4, 2, 0], np.int32)
    for t, j in zip(tspec.NgramDrafter(3).draft_batch(contexts, want, 4),
                    jspec.NgramDrafter(3).draft_batch(contexts, want, 4)):
        assert np.array_equal(t, j)


def test_ngram_drafter_lookup():
    """The JAX drafter's worked cases, on the port's."""
    d = tspec.NgramDrafter(ngram_max=3)
    assert d.draft(np.array([1, 5, 6, 7, 9, 2, 5, 6, 7], np.int32), 2).tolist() == [9, 2]
    assert d.draft(np.array([5, 6, 1, 5, 6, 2, 5, 6], np.int32), 1).tolist() == [2]
    assert d.draft(np.array([1, 2, 3, 4], np.int32), 3).size == 0
    assert d.draft(np.array([3] * 8, np.int32), 4).tolist() == [3] * 4
    with pytest.raises(ValueError, match="ngram_max"):
        tspec.NgramDrafter(0)


# --------------------------------------------------------------------------
# the verify step on one cache state
# --------------------------------------------------------------------------

N_SLOTS, K, PS = 5, 4, 4
PROMPTS = [5, 9, 3, 7, 0]          # slot 4 stays idle


def _prefilled(setup, layout, cache_dtype):
    """Both frameworks' slot caches after one prefill call of the prompts,
    and the port's next-token logits of that call."""
    jmodel, jparams, tmodel, tparams = setup
    rng = np.random.default_rng(11)
    toks = np.zeros((N_SLOTS, 16), np.int32)
    for s, n in enumerate(PROMPTS):
        toks[s, :n] = rng.integers(0, 64, n)
    nv = np.maximum(np.array(PROMPTS, np.int32), 1)
    gate = np.array(PROMPTS) > 0
    start = np.zeros(N_SLOTS, np.int32)
    if layout == "paged":
        nb = 32 // PS
        bt = (np.arange(N_SLOTS * nb, dtype=np.int32) + 1).reshape(N_SLOTS, nb)
        jc = dict(jmodel.init_paged_cache(jparams, N_SLOTS * nb, PS, cache_dtype),
                  block_tables=jnp.asarray(bt))
        tc = dict(tmodel.init_paged_cache(tparams, N_SLOTS * nb, PS, cache_dtype,
                                          device="cpu"), block_tables=torch.tensor(bt))
    else:
        jc = jmodel.init_cache(jparams, N_SLOTS, 32, cache_dtype)
        tc = tmodel.init_cache(tparams, N_SLOTS, 32, cache_dtype, device="cpu")
    jscfg = JaxServeConfig(max_len=32, cache_dtype=cache_dtype)
    _, jc = jengine.build_prefill_chunk(jmodel, jscfg, 16)(
        jparams, jc, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(nv),
        jnp.asarray(gate))
    last, tc = tengine.build_prefill_chunk(tmodel, ServeConfig(max_len=32), 16)(
        tparams, tc, torch.tensor(toks), torch.tensor(start), torch.tensor(nv),
        torch.tensor(gate))
    return jc, tc, torch.argmax(last, -1).to(torch.int32).numpy()


def _greedy(setup, tc, tok0, lengths):
    """K greedy tokens per slot from the port's model on a copy of its
    cache: the drafts the step must accept."""
    _, _, tmodel, tparams = setup
    cache = {k: (v.clone() if torch.is_tensor(v) else {n: t.clone() for n, t in v.items()})
             for k, v in tc.items()}
    tok, out = torch.tensor(tok0)[:, None], []
    pos = torch.tensor(lengths)
    for i in range(K):
        logits, cache = tmodel.decode_step(tparams, cache, tok, pos + i)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        out.append(tok[:, 0])
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("eos", [False, True], ids=["no-eos", "eos"])
@pytest.mark.parametrize("layout, cache_dtype", [("dense", "float32"), ("dense", "fp2fx8"),
                                                 ("paged", "float32"), ("paged", "fp2fx8")])
def test_spec_step_matches_jax(setup, layout, cache_dtype, eos):
    """``build_spec_step`` on the same cache state gives JAX's ``emitted``,
    ``lengths``, ``active``, ``budget``, ``n_acc``, ``ok`` and last token:
    slots whose drafts are right for 0, 1, 2 and all 4 lanes, a ragged
    draft count, a budget that cuts the emission, an idle slot, and (eos)
    a stop token inside an accepted prefix.  A second step with no drafts
    then reads the cache the first one wrote."""
    jmodel, jparams, tmodel, tparams = setup
    jc, tc, tok0 = _prefilled(setup, layout, cache_dtype)
    lengths = np.array(PROMPTS, np.int32)
    active = lengths > 0
    greedy = _greedy(setup, tc, tok0, lengths)
    right = [0, 1, 2, 4, 0]
    draft = np.where(np.arange(K)[None] < np.array(right)[:, None], greedy, (greedy + 1) % 64)
    draft = draft.astype(np.int32)
    n_draft = np.array([4, 3, 4, 4, 0], np.int32)
    budget = np.array([9, 2, 9, 9, 0], np.int32)
    eos_id = int(greedy[3, 1]) if eos else None
    jstep = jspec.build_spec_step(jmodel, JaxServeConfig(max_len=32, eos_id=eos_id), K)
    tstep = tspec.build_spec_step(tmodel, ServeConfig(max_len=32, eos_id=eos_id), K)
    last = tok0[:, None].astype(np.int32)
    for i in range(2):
        jout = jstep(jparams, jc, jnp.asarray(last), jnp.asarray(draft), jnp.asarray(n_draft),
                     jnp.asarray(lengths), jnp.asarray(active), jnp.asarray(budget))
        tout = tstep(tparams, tc, torch.tensor(last), torch.tensor(draft),
                     torch.tensor(n_draft), torch.tensor(lengths), torch.tensor(active),
                     torch.tensor(budget))
        jc, tc = jout[1], tout[1]
        assert tout[8] == {}
        for i, name in ((0, "emitted"), (2, "last_tok"), (3, "lengths"), (4, "active"),
                        (5, "budget"), (6, "n_acc"), (7, "ok")):
            assert np.array_equal(tout[i].numpy(), np.asarray(jout[i])), name
        if i == 0:   # every slot accepts the drafts that were right
            assert tout[6].tolist() == right
        last, lengths = tout[2].numpy(), tout[3].numpy()
        active, budget = tout[4].numpy(), tout[5].numpy()
        draft, n_draft = np.zeros_like(draft), np.zeros_like(n_draft)
    assert tout[6].tolist() == [0] * N_SLOTS


# --------------------------------------------------------------------------
# the scheduler: spec serving against JAX's and against continuous
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(kv_layout="dense"),
    dict(kv_layout="paged", page_size=4, cache_dtype="fp2fx8"),
    dict(kv_layout="paged", page_size=4, prefix_cache=True),
], ids=["dense", "paged-fp2fx8", "paged-prefix"])
def test_spec_serving_matches_jax_and_continuous(setup, kw):
    """N-gram spec serving of 5 motif-tiled requests through 2 slots: the
    JAX spec scheduler's tokens and counters, and the port's continuous
    scheduler's tokens, with drafts both accepted and rejected."""
    reqs = _requests(5, 0)
    tout, teng = _run_port(setup, reqs, **kw)
    jout, jeng = _run_jax(setup, reqs, **kw)
    assert tout == jout
    for key in SPEC_STATS:
        assert teng.stats[key] == jeng.stats[key], key
    st = teng.stats
    assert 0 < st["accepted_tokens"] < st["draft_tokens"]
    base, _ = _run_port(setup, reqs, scheduler="continuous", **kw)
    assert tout == base
    if kw["kv_layout"] == "paged":
        assert teng.pool.pages_in_use == (teng.trie.n_pages() if teng.trie else 0)


def test_spec_eos_matches_jax(setup):
    """EOS cuts the emission inside the accepted prefix and frees the slot,
    as JAX's spec scheduler and the port's continuous one do."""
    reqs = _requests(5, 2)
    base, _ = _run_port(setup, reqs, scheduler="continuous")
    eos = int(collections.Counter(t for toks in base.values()
                                  for t in toks).most_common(1)[0][0])
    tout, teng = _run_port(setup, reqs, eos_id=eos)
    jout, jeng = _run_jax(setup, reqs, eos_id=eos)
    assert tout == jout
    assert tout == _run_port(setup, reqs, scheduler="continuous", eos_id=eos)[0]
    assert any(len(t) < r["max_new"] for t, r in zip(tout.values(), reqs))
    for rid, toks in tout.items():
        assert eos not in toks[:-1]
    for key in SPEC_STATS:
        assert teng.stats[key] == jeng.stats[key], key


def test_model_drafter_shares_pool_full_acceptance(setup):
    """A draft model identical to the target has every draft accepted (its
    sync and greedy loop are the target's own continuation, bit for bit),
    and the outputs equal continuous serving and JAX's model drafter."""
    _, _, tmodel, tparams = setup
    jmodel, jparams, _, _ = setup
    reqs = _requests(4, 3)
    tout, teng = _run_port(setup, reqs, draft=(tmodel, tparams), spec_mode="model",
                           draft_k=3)
    st = teng.stats
    assert st["draft_tokens"] > 0 and st["accepted_tokens"] == st["draft_tokens"]
    assert tout == _run_port(setup, reqs, scheduler="continuous")[0]
    jout, jeng = _run_jax(setup, reqs, draft=(jmodel, jparams), spec_mode="model",
                          draft_k=3)
    assert tout == jout
    for key in SPEC_STATS:
        assert teng.stats[key] == jeng.stats[key], key


def test_smoke_drafter_from_the_zoo(setup):
    """``draft_model`` names a zoo arch: the drafter is its smoke config at
    the target's vocab, head width 16, random weights from a generator
    seeded 1 on the engine's device, with a dense fp32 cache.  Whatever it
    drafts, the output is the continuous scheduler's."""
    _, _, tmodel, tparams = setup
    reqs = _requests(3, 4)
    tout, teng = _run_port(setup, reqs, spec_mode="model", draft_model="qwen2-1.5b",
                           kv_layout="paged", page_size=4)
    d = teng.drafter
    assert isinstance(d, tspec.ModelDrafter)
    assert d.model.cfg.vocab == 64 and d.model.cfg.d_head == 16
    assert d.model.cfg.attn_mode == "kernel"
    assert d.cache["blocks"]["k"].dtype == torch.float32
    ref = build_model(d.model.cfg).init(1, device="cpu")
    assert torch.equal(d.params["embed"]["table"], ref["embed"]["table"])
    assert teng.stats["draft_tokens"] > 0
    assert teng.stats["model_calls"] > teng.stats["spec_steps"] + teng.stats["prefills"]
    assert tout == _run_port(setup, reqs, scheduler="continuous", kv_layout="paged",
                             page_size=4)[0]


# --------------------------------------------------------------------------
# rollback under page pressure; validation; the default device
# --------------------------------------------------------------------------


def test_spec_preemption_rollback_keeps_refcounts(setup):
    """A pool too small for the load preempts mid-spec; afterwards every
    page's refcount equals the radix trie's references (the slots drained),
    the audit held at every checkpoint, and the tokens equal the dense
    continuous run's and JAX's spec run's."""
    rng = np.random.default_rng(4)
    head = rng.integers(0, 64, 12).astype(np.int32)
    reqs = [dict(rid=i, tokens=np.concatenate([head, rng.integers(0, 64, 3).astype(np.int32)]),
                 max_new=10) for i in range(6)]
    kw = dict(n_slots=3, max_len=40, kv_layout="paged", page_size=4, n_pages=12,
              prefix_cache=True)
    tout, teng = _run_port(setup, reqs, **kw)
    assert teng.stats["preemptions"] > 0, "the pool was meant to be under pressure"
    assert teng.stats["audits"] > 0
    assert not teng.active.any() and all(not p for p in teng.slot_pages)
    refs = collections.Counter()
    stack = [teng.trie.root]
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        refs.update(node.pages)
    for p in range(1, teng.pool.n_pages + 1):
        assert teng.pool.refs[p] == refs.get(p, 0)
    assert teng.pool.pages_in_use == teng.trie.n_pages()
    base, _ = _run_port(setup, reqs, scheduler="continuous", n_slots=3, max_len=40)
    assert tout == base
    jout, jeng = _run_jax(setup, reqs, **kw)
    assert tout == jout
    assert teng.stats["preemptions"] == jeng.stats["preemptions"]


def test_spec_validation(setup):
    """JAX's refusals: a sampled spec run, draft_k 0, an unknown drafter, a
    model drafter with neither a model nor a zoo name, a draft vocab that
    is not the target's, an unknown scheduler."""
    _, _, tmodel, tparams = setup

    def engine(draft=None, **kw):
        return tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(**_scfg(**kw)),
                                     device="cpu", draft=draft)
    with pytest.raises(ValueError, match="greedy-only"):
        engine(temperature=0.7)
    with pytest.raises(ValueError, match="draft_k"):
        engine(draft_k=0)
    with pytest.raises(ValueError, match="unknown spec_mode"):
        engine(spec_mode="beam")
    with pytest.raises(ValueError, match="needs draft"):
        engine(spec_mode="model")
    other = build_model(tmodel.cfg.with_(vocab=128))
    with pytest.raises(ValueError, match="vocab 128 != target vocab 64"):
        engine(draft=(other, other.init(0, device="cpu")), spec_mode="model")
    with pytest.raises(ValueError, match="unknown scheduler"):
        engine(scheduler="warp")


def test_spec_default_device_is_the_card(setup, monkeypatch):
    """``device=None`` means the card, for spec serving as for the rest:
    without one the engine raises instead of falling back to the CPU, and
    so does ``serve``."""
    _, _, tmodel, tparams = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(**_scfg()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsched.serve(tmodel, tparams, [], ServeConfig(**_scfg(spec_mode="model")),
                     draft=(tmodel, tparams))
