"""The port's page pool and radix trie against the JAX package's.

``repro_torch.serve.kvpool`` is an own copy of ``repro.serve.kvpool`` (the
port imports nothing of that package).  The same seeded operation
sequences drive both; every observation must agree: the pages handed out,
the refcounts, ``match`` results, eviction counts, the trie's page count
and the audit outcome after every step.
"""
import numpy as np
import pytest

from repro.serve import kvpool as jkv
from repro_torch.serve import kvpool as tkv


def _drive(kv, ops, n_pages=24, ps=2, vocab=3):
    """A scheduler-shaped op sequence over one module's PagePool and
    RadixTrie (admit with a pinned match, finish, evict, partial match,
    allocation bursts); returns the list of observations."""
    pool = kv.PagePool(n_pages)
    trie = kv.RadixTrie(pool, ps)
    holders: list = []
    seen = []
    for kind, a, b in ops:
        k = kind % 5
        if k == 0:                            # admit
            n_tok = ps * (1 + a % 4) + b % ps
            toks = [(a * 7 + b * 3 + j) % vocab for j in range(n_tok)]
            matched, n_match = trie.match(toks)
            for p in matched:
                pool.incref(p)
            need = -(-n_tok // ps) - len(matched)
            tail = pool.alloc(need) if need > 0 else []
            if tail is None:
                seen.append(("evicted", trie.evict(need)))
                tail = pool.alloc(need)
            if tail is None:
                for p in matched:
                    pool.decref(p)
            else:
                pages = matched + tail
                holders.append(pages)
                nfull = n_tok // ps
                if nfull:
                    seen.append(("adopted", trie.insert(toks[:nfull * ps],
                                                        pages[:nfull])))
            seen.append(("admit", list(matched), n_match, tail))
        elif k == 1 and holders:              # finish
            for p in holders.pop(a % len(holders)):
                pool.decref(p)
        elif k == 2:                          # eviction storm
            seen.append(("evicted", trie.evict(1 + a % 4)))
        elif k == 3:                          # a read-only match
            toks = [(a + j * b) % vocab for j in range(ps * (1 + b % 3))]
            seen.append(("match",) + tuple(trie.match(toks)))
        else:                                 # a burst of single pages
            got = pool.alloc(1 + a % 3)
            if got is not None:
                holders.append(got)
            seen.append(("alloc", got))
        try:
            pool.audit(holders, trie)
            seen.append(("audit", "clean"))
        except kv.AuditError as e:
            seen.append(("audit", str(e)))
        seen.append(("state", pool.refs.tolist(), pool.free_pages,
                     pool.pages_in_use, trie.n_pages()))
    return seen


@pytest.mark.parametrize("seed", range(6))
def test_pool_and_trie_agree_with_jax(seed):
    rng = np.random.default_rng(seed)
    ops = [tuple(int(x) for x in rng.integers(0, 64, 3)) for _ in range(60)]
    ref = _drive(jkv, ops)
    got = _drive(tkv, ops)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g == r, f"step {i}: {g} != {r}"
    assert any(o[0] == "evicted" and o[1] > 0 for o in ref)   # eviction ran
    assert any(o[0] == "admit" and o[2] > 0 for o in ref)     # matches hit


def _corrupted(kv, how):
    pool = kv.PagePool(8)
    trie = kv.RadixTrie(pool, 2)
    pages = pool.alloc(3)
    trie.insert([1, 2, 3, 4], pages[:2])
    holders = [pages]
    pool.audit(holders, trie)                 # clean before the corruption
    if how == "refcount":
        pool.refs[pages[0]] += 1
    elif how == "double_free":
        pool._free.append(pool._free[-1])
    else:                                     # a freed page still in the trie
        pool.refs[pages[1]] = 0
        holders = [[pages[0], pages[2]]]
    with pytest.raises(kv.AuditError) as err:
        pool.audit(holders, trie)
    return str(err.value)


@pytest.mark.parametrize("how", ["refcount", "double_free", "freed_trie_page"])
def test_corruption_raises_audit_error_in_both(how):
    assert _corrupted(tkv, how) == _corrupted(jkv, how)


def test_null_page_is_reserved():
    for kv in (jkv, tkv):
        pool = kv.PagePool(4)
        assert kv.NULL_PAGE == 0 and pool.refs[0] == 1
        assert sorted(pool.alloc(4)) == [1, 2, 3, 4]
        assert pool.alloc(1) is None
        with pytest.raises(ValueError):
            kv.PagePool(0)
