"""The port's sharding rules against the JAX package's, in one process.

Spec math needs no devices: both sides run on an abstract mesh of the
production geometry (16 x 16 and 2 x 16 x 16), the JAX side on its
``AbstractMesh``, the port's on its own, at the full size of every assigned
architecture (JAX's ``eval_shape``, the port's ``device="meta"``).  The
logical-axes trees, the parameter specs (``fsdp=True``, as the dry-run
takes them), the decode cache's specs and the train state's specs must be
equal, leaf for leaf and entry for entry.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ASSIGNED
from repro.configs import get_config as jax_get_config
from repro.configs.base import MeshConfig as JaxMeshConfig
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.distributed import sharding as jshd
from repro.distributed.compat import abstract_mesh
from repro.models import build_model as jax_build_model
from repro.models.layers import Param, unbox
import repro.optim as joptim
from repro.train.state import state_shardings as jax_state_shardings
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.configs.base import MeshConfig, ServeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.train.state import abstract_state, state_shardings
from repro_torch.tree import tree_leaves

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, axes = MESHES[name]
    return abstract_mesh(sizes, axes), tmesh.AbstractMesh(sizes, axes)


def _jax_specs(tree):
    """{keystr path: spec tuple} of a JAX NamedSharding tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(kp): tuple(s.spec) for kp, s in flat}


def _port_specs(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: s for k in tree for p, s in _port_specs(tree[k], f"{prefix}[{k!r}]").items()}
    return {prefix: tuple(tree.spec)}


def _tuples(tree):
    """A nested dict of axes with tuple leaves (JAX's ``boxed_axes``)."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


_ARCH_CACHE: dict = {}


def _arch(name):
    """(JAX cfg, JAX boxed eval_shape tree, port cfg, port meta params)."""
    if name not in _ARCH_CACHE:
        jcfg = jax_get_config(name)
        boxed = jax.eval_shape(lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
        cfg = get_config(name)
        _ARCH_CACHE[name] = (jcfg, boxed, cfg, build_model(cfg).init(device="meta"))
    return _ARCH_CACHE[name]


@pytest.mark.parametrize("name", ASSIGNED)
def test_axes_tree_matches_jax(name):
    """``build_model(cfg).axes()`` is JAX's ``boxed_axes`` of the init, and
    a meta init allocates nothing."""
    jcfg, boxed, cfg, params = _arch(name)
    want = _tuples(jax.tree.map(lambda p: p.axes, boxed,
                                is_leaf=lambda x: isinstance(x, Param)))
    assert _tuples(build_model(cfg).axes()) == want
    leaves = tree_leaves(params)
    assert all(t.is_meta for t in leaves)
    assert sorted(tuple(t.shape) for t in leaves) == \
        sorted(tuple(a.shape) for a in jax.tree.leaves(unbox(boxed)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ASSIGNED)
def test_param_shardings_match_jax(mesh, name):
    """``param_shardings`` under ``default_rules(mesh, cfg, fsdp=True)``:
    JAX's ``test_param_shardings_divisible_all_archs`` held as an equality,
    with the divisibility it checks."""
    jmesh, tm = _meshes(mesh)
    jcfg, boxed, cfg, params = _arch(name)
    jrules = jshd.default_rules(jmesh, jcfg, fsdp=True)
    rules = shd.default_rules(tm, cfg, fsdp=True)
    assert rules == jrules
    want = _jax_specs(jshd.param_shardings(jmesh, boxed, jrules))
    got = _port_specs(shd.param_shardings(tm, params, build_model(cfg).axes(), rules))
    assert got == want
    sizes = tm.shape
    for path, spec in got.items():
        shape = _at(params, path).shape
        for dim, e in zip(shape, spec):
            if e is not None:
                n = 1
                for a in (e if isinstance(e, tuple) else (e,)):
                    n *= sizes[a]
                assert dim % n == 0, (name, path, spec)


def _at(tree, path):
    for k in path[2:-2].split("']['"):
        tree = tree[k]
    return tree


def test_cache_shardings_match_jax():
    """zamba2-7b's decode cache at 128 x 32,768 (bf16), made on the meta
    device: the shared attention's K/V take ``model`` on the sequence axis
    (sequence parallelism), the Mamba2 state on the heads."""
    jmesh, tm = _meshes("single")
    jcfg, boxed, cfg, params = _arch("zamba2-7b")
    jcache = jax.eval_shape(lambda: jax_build_model(jcfg).init_cache(
        unbox(boxed), 128, 32768, jnp.bfloat16))
    want = _jax_specs(jshd.cache_shardings(jmesh, jcache, jshd.default_rules(jmesh, jcfg)))
    cache = build_model(cfg).init_cache(params, 128, 32768, "bfloat16", device="meta")
    got = _port_specs(shd.cache_shardings(tm, cache, shd.default_rules(tm, cfg)))
    assert got == want
    assert "model" in got["['shared_attn']['k']"]
    assert "model" in got["['blocks']['ssm']"]


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b"])
def test_state_shardings_match_jax(name, opt):
    """``state_shardings``: the params', the optimizer's (Adafactor's row and
    column statistics drop an entry) and the step's specs; JAX's state
    also carries an ``rng``, which the port's has not."""
    jmesh, tm = _meshes("single")
    jcfg, _, cfg, _ = _arch(name)
    want = _jax_specs(jax_state_shardings(
        jmesh, jax_build_model(jcfg), joptim.OptConfig(name=opt),
        jshd.default_rules(jmesh, jcfg)))
    assert want.pop("['rng']") == ()
    got = _port_specs(state_shardings(tm, build_model(cfg), optim.OptConfig(name=opt),
                                      shd.default_rules(tm, cfg)))
    assert got == want
    state, axes = abstract_state(build_model(cfg), optim.OptConfig(name=opt))
    assert state["step"].is_meta and axes == build_model(cfg).axes()


def test_spec_math_matches_jax():
    """spec_for_axes (one mesh axis used once), _divisible (whisper's vocab
    does not divide 16) and the rules without a config."""
    jmesh, tm = _meshes("single")
    assert shd.default_rules(tm) == jshd.default_rules(jmesh)
    rules = shd.default_rules(tm)
    for axes in [("embed", "mlp"), ("batch", "seq", "embed"), ("heads", "head_dim"),
                 ("vocab", "embed"), None, ()]:
        assert tuple(shd.spec_for_axes(axes, rules)) == tuple(jshd.spec_for_axes(axes, rules))
    rules = dict(rules, embed="model")       # would collide with mlp -> model
    assert tuple(shd.spec_for_axes(("embed", "mlp"), rules)) == \
        tuple(jshd.spec_for_axes(("embed", "mlp"), rules)) == ("model",)
    assert tuple(shd._divisible(shd.Spec("model"), (51865,), tm)) == \
        tuple(jshd._divisible(P("model"), (51865,), jmesh)) == ()
    jm3, tm3 = _meshes("multi")
    rules3 = shd.default_rules(tm3, fsdp=True)
    assert rules3 == jshd.default_rules(jm3, fsdp=True)
    assert tuple(shd.spec_for_axes(("batch", "embed"), rules3)) == \
        tuple(jshd.spec_for_axes(("batch", "embed"), rules3)) == (("pod", "data"),)


def test_batch_shardings_match_jax():
    jmesh, tm = _meshes("multi")
    shapes = {"tokens": (64, 128), "targets": (64, 128), "odd": (3, 5), "scalar": ()}
    rules = shd.default_rules(tm)
    want = _jax_specs(jshd.batch_shardings(
        jmesh, {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()},
        jshd.default_rules(jmesh)))
    assert _port_specs(shd.batch_shardings(tm, shapes, rules)) == want


def test_placements_of_a_spec():
    """A spec's DTensor placements: one a mesh dim; two mesh axes on one
    tensor dim shard it on both, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    tm = tmesh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.NamedSharding(tm, shd.Spec(("pod", "data"), None, "model")).placements() == \
        (Shard(0), Shard(0), Shard(2))
    assert shd.NamedSharding(tm, shd.Spec()).placements() == (Replicate(),) * 3
    assert shd.NamedSharding(tm, shd.Spec(None, "data")).placements() == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        shd.NamedSharding(tm, shd.Spec(("model", "data"))).placements()


def test_constrain_acts_passes_without_a_mesh():
    """Without an active context, or on a plain tensor, ``constrain_acts``
    returns its input."""
    x = torch.ones(2, 3, 4)
    assert shd.constrain_acts(x) is x
    tm = tmesh.AbstractMesh((2, 2), ("data", "model"))
    with shd.activation_rules(tm, shd.default_rules(tm)):
        assert shd.constrain_acts(x) is x
        assert shd._ACT_CTX
    assert not shd._ACT_CTX


def test_production_mesh_needs_its_ranks():
    """The production meshes raise, naming their size, in a world smaller
    than 256 (512) ranks; the host mesh likewise."""
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        tmesh.make_host_mesh((2, 2), device="cpu")


def test_mesh_and_serve_configs_match_jax():
    assert MeshConfig() == MeshConfig(**vars(JaxMeshConfig()))
    assert MeshConfig().multi_pod is JaxMeshConfig().multi_pod is False
    assert MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model")).multi_pod
    assert ServeConfig().seq_parallel is JaxServeConfig().seq_parallel is False
