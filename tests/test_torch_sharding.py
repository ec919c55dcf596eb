"""Logical-axis sharding without ranks: `repro_torch.core.sharding`'s
specs held entry by entry against the JAX package's `PartitionSpec`s.

Spec resolution needs only a mesh's dim names and sizes, so both packages
get a stand-in mesh (JAX's `set_mesh` reads `mesh.shape`, the port's
`mesh_dim_names` and `shape`).  Under each of the six axis envs and the
mesh shapes (8,1), (1,8) and (4,2), the port's `model_pspecs`, the
optimizer's `state_specs`, `cache_pspecs` and `batch_pspecs` equal
JAX's for the SMOKE config of every arch.  Also the counterparts of
`tests/test_parallelism.py`'s unit tests, and `placements`."""
import types

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.core import sharding as JSH
from repro.launch import steps as JST
from repro.models import model as JMD
from repro.optim.optimizers import get_optimizer as jax_optimizer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import sharding as SH
from repro_torch.core.pipeline import bubble_fraction
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.models.common import tree_leaves
from repro_torch.optim.optimizers import get_optimizer

ENVS = ["DP_ENV", "DP_TP_ENV", "TP_ENV", "TRAIN_ENV", "DP_TP_SP_ENV",
        "TRAIN_SP_ENV"]
SHAPES = [(8, 1), (1, 8), (4, 2)]
B, S = 8, 32


def _fake_mesh(shape):
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=shape)


class _meshes:
    """Both packages' thread-local mesh and env set for the block."""

    def __init__(self, env, shape):
        self.env, self.shape = env, shape

    def __enter__(self):
        JSH.set_mesh(types.SimpleNamespace(
            shape={"data": self.shape[0], "model": self.shape[1]}))
        JSH.set_axis_env(getattr(JSH, self.env))
        SH.set_mesh(_fake_mesh(self.shape))
        SH.set_axis_env(getattr(SH, self.env))

    def __exit__(self, *exc):
        JSH.set_mesh(None)
        JSH.set_axis_env(JSH.DP_TP_ENV)
        SH.set_mesh(None)
        SH.set_axis_env(SH.DP_TP_ENV)


def _jax_leaves(tree):
    return [tuple(p) for p in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


# ---------------------------------------------------------------------------
# counterparts of tests/test_parallelism.py's unit tests
# ---------------------------------------------------------------------------
def test_bubble_fraction_formula():
    assert bubble_fraction(1, 8) == 0.0
    assert abs(bubble_fraction(4, 4) - 3 / 7) < 1e-12
    # GPipe's claim: bubble -> 0 as microbatches grow
    assert bubble_fraction(4, 64) < 0.05


def test_resolve_spec_drops_indivisible_dims():
    with SH.use_mesh(types.SimpleNamespace(mesh_dim_names=("model",),
                                           shape=(1,))), \
            SH.axis_env(SH.DP_TP_ENV):
        # whisper's 51865 vocab on a size-1 model axis shards trivially
        assert SH.resolve_spec((51865,), ("model",)) == ("model",)
    with SH.use_mesh(_fake_mesh((1, 16))), SH.axis_env(SH.DP_TP_ENV):
        # ... and stays whole on 16 shards
        assert SH.resolve_spec((51865, 64), ("model", None)) == (None, None)


def test_axis_env_filters_absent_mesh_axes():
    with SH.use_mesh(_fake_mesh((1, 1))), SH.axis_env(SH.DP_TP_ENV):
        # 'pod' is not in this mesh; logical batch = ("pod","data") -> data
        assert SH.logical("batch") == ("data",)
        assert SH.logical("batch", None, "model") == ("data", None, "model")
    with SH.use_mesh(_fake_mesh((2, 2))), SH.axis_env(SH.DP_ENV):
        assert SH.logical("batch") == (("data", "model"),)


def test_no_mesh_shard_is_identity():
    import torch
    x = torch.ones(4, 4)
    assert SH.shard(x, "batch", "model") is x
    with SH.use_mesh(_fake_mesh((2, 2))):
        assert SH.shard(x, "batch", "model") is x   # not a DTensor


def test_placements_on_a_fake_mesh():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _fake_mesh((4, 2))
    assert SH.placements(("data", None, "model"), mesh) == (Shard(0),
                                                           Shard(2))
    assert SH.placements((None, "model"), mesh) == (Replicate(), Shard(1))
    assert SH.placements((("data", "model"), None), mesh) == (Shard(0),
                                                             Shard(0))
    assert SH.placements((None, None), mesh) == (Replicate(), Replicate())
    # a mesh axis the spec names but the mesh lacks is dropped
    assert SH.placements((("pod", "data"), "model"),
                         mesh) == (Shard(0), Shard(1))
    assert SH.placements((), mesh) == (Replicate(), Replicate())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("env", ENVS)
def test_resolve_param_spec_matches_jax(env, shape):
    cases = [((256, 128), ("model", None)), ((128, 256), (None, "model")),
             ((4, 128, 96), ("layers", None, "model")),
             ((4, 8, 64, 32), ("layers", "model", None, None)),
             ((51865, 64), ("model", None)), ((7,), (None,)),
             ((4, 6, 5), ("layers", None, None))]
    with _meshes(env, shape):
        for dims, names in cases:
            assert SH.resolve_param_spec(dims, names) == tuple(
                JSH.resolve_param_spec(dims, names)), (dims, names)
            assert SH.resolve_spec(dims, names) == tuple(
                JSH.resolve_spec(dims, names)), (dims, names)
        assert SH.logical("batch", "seq", "model") == tuple(
            JSH.logical("batch", "seq", "model"))
        for name in ("batch", "model", "seq", "fsdp"):
            assert SH.axis_size(getattr(SH, env).resolve(name)) == \
                JSH.axis_size(getattr(JSH, env).resolve(name))


def test_arch_registries_agree():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_cache_batch_specs_match_jax(arch, env):
    """model_pspecs, AdamW's state_specs, cache_pspecs and batch_pspecs
    equal JAX's entry by entry on (8,1), (1,8) and (4,2)."""
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    C = S + (cfg.num_patches if cfg.arch_type == "vlm" else 0)
    for shape in SHAPES:
        with _meshes(env, shape):
            ps, jps = MD.model_pspecs(cfg), JMD.model_pspecs(jcfg)
            assert tree_leaves(ps) == _jax_leaves(jps), shape
            ost = get_optimizer("adamw", lambda s: 1e-3).state_specs(ps)
            jost = jax_optimizer("adamw", lambda s: 1e-3).state_specs(jps)
            assert tree_leaves(ost["mu"]) == _jax_leaves(jost["mu"])
            assert ost["step"] == tuple(jost["step"]) == ()
            cs = ST.cache_pspecs(cfg, MD.cache_specs(cfg, B, C))
            jcs = JST.cache_pspecs(jcfg, JMD.cache_specs(jcfg, B, C))
            assert tree_leaves(cs) == _jax_leaves(jcs), shape
            bs = ST.batch_pspecs(cfg, ST.batch_abstract(cfg, B, S))
            jbs = JST.batch_pspecs(jcfg, JST.batch_abstract(jcfg, B, S))
            assert tree_leaves(bs) == _jax_leaves(jbs), shape


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k",
                                  "decode_cb_32k"])
def test_build_plan_specs_match_jax(kind):
    """build_plan's in/out specs equal JAX's plan's PartitionSpecs (its
    NamedShardings' specs), under TRAIN_ENV on a (4, 2) mesh; the
    abstract inputs are meta tensors of JAX's shapes."""
    import torch
    from repro.configs import SHAPES as JSHAPES
    from repro_torch.configs import SHAPES as TSHAPES
    cfg = get_config("qwen3-0.6b", smoke=True)
    jcfg = jax_config("qwen3-0.6b", smoke=True)
    with _meshes("TRAIN_ENV", (4, 2)):
        mesh = _fake_mesh((4, 2))
        plan = ST.build_plan(cfg, TSHAPES[kind], mesh)
        jmesh = types.SimpleNamespace(shape={"data": 4, "model": 2})
        jplan = _jax_plan_specs(jcfg, JSHAPES[kind], jmesh)
    assert [tuple(t.shape) for t in _flat(plan.args)] == \
        [tuple(t.shape) for t in jax.tree_util.tree_leaves(jplan["args"])]
    assert all(t.device.type == "meta" for t in _flat(plan.args))
    assert _flat(plan.in_specs) == _jax_leaves(jplan["in"])
    assert _flat(plan.out_specs) == _jax_leaves(jplan["out"])
    pl = _flat(plan.in_placements, leaf=lambda t: not isinstance(t, dict)
               and len(t) == 2 and not isinstance(t[0], (tuple, dict)))
    assert len(pl) == len(_flat(plan.in_specs))
    assert plan.donate_argnums == jplan["donate"]
    assert isinstance(plan.args[0]["embed"], torch.Tensor)


def _is_spec(t):
    return isinstance(t, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in t)


def _flat(t, leaf=None):
    """The leaves of a tree of dicts and tuples, in JAX's order; a spec
    tuple (or what `leaf` accepts) is a leaf."""
    leaf = leaf or (lambda x: _is_spec(x) or not isinstance(x, (dict,
                                                                 tuple)))
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat(t[k], leaf)]
    if leaf(t):
        return [t]
    return [x for e in t for x in _flat(e, leaf)]


def _jax_plan_specs(jcfg, shape, jmesh):
    """JAX's build_plan under a stand-in mesh: its NamedShardings need
    a real mesh, so the specs are rebuilt as it builds them."""
    names = {}

    class _NS:
        def __init__(self, mesh, spec):
            self.spec = spec

    orig = JST.NamedSharding
    JST.NamedSharding = _NS
    try:
        plan = JST.build_plan(jcfg, shape, jmesh)
    finally:
        JST.NamedSharding = orig

    def specs(tree):
        return jax.tree_util.tree_map(
            lambda n: n.spec, tree, is_leaf=lambda x: isinstance(x, _NS))
    names["in"] = {f"{i:02d}": specs(t)
                   for i, t in enumerate(plan.in_shardings)}
    out = plan.out_shardings
    names["out"] = ({f"{i:02d}": specs(t) for i, t in enumerate(out)}
                    if isinstance(out, tuple) else specs(out))
    names["args"] = {f"{i:02d}": t for i, t in enumerate(plan.args)}
    names["donate"] = plan.donate_argnums
    return names


def test_mesh_shards_matches_jax():
    for env in ENVS:
        with _meshes(env, (4, 2)):
            jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                          shape={"data": 4, "model": 2})
            for name in ("batch", "model", "seq", "fsdp", "layers"):
                assert SH.mesh_shards(name, _fake_mesh((4, 2))) == \
                    JSH.mesh_shards(name, jmesh), (env, name)


# ---------------------------------------------------------------------------
# a world of one in this process: the mesh factories and the kernel
# wrappers' DTensor boundary (the plain versions, on the CPU)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_mesh_factories_check_the_world(one_rank):
    from repro_torch.launch.mesh import make_host_mesh
    assert one_rank.mesh_dim_names == ("data", "model")
    assert tuple(one_rank.shape) == (1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_host_mesh(2, 1)


def test_kernel_wrappers_take_local_shards(one_rank):
    """flash_attention, paged_attention and nc_roundtrip given DTensors
    run on the local tensors and hand back DTensors laid out as their
    input, equal to the plain tensors' results; on the CPU no launch is
    counted."""
    import torch
    from repro_torch.kernels import ops
    mesh = one_rank
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, h, 16, generator=g) for h in (4, 2, 2))
    pools = [torch.randn(6, 4, 2, 16, generator=g) for _ in range(2)]
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    pos = torch.tensor([5, 2], dtype=torch.int32)
    x, u = torch.randn(33, generator=g), torch.rand(33, generator=g)
    want = (ops.flash_attention(q, k, v),
            ops.paged_attention(q[:, 0], *pools, bt, pos),
            ops.nc_roundtrip(x, u))
    with SH.axis_env(SH.DP_TP_ENV), SH.use_mesh(mesh):
        heads = SH.logical("batch", None, "model", None)
        qd, kd, vd = (SH.distribute(t, heads, mesh) for t in (q, k, v))
        ops.reset_launches()
        q0 = SH.distribute(q[:, 0], heads[:1] + heads[2:], mesh)
        pd = [SH.distribute(p, (None, None) + heads[2:], mesh)
              for p in pools]
        got = (ops.flash_attention(qd, kd, vd),
               ops.paged_attention(q0, *pd, bt, pos),
               ops.nc_roundtrip(SH.distribute(x, (None,), mesh), u))
        launches = [getattr(ops, n).launches for n in
                    ("flash_attention", "paged_attention", "nc_pack")]
    for a, b in zip(got, want):
        assert SH.is_dtensor(a)
        assert torch.equal(a.to_local(), b)
    assert got[0].placements == qd.placements
    assert launches == [0, 0, 0]
