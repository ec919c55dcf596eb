"""The port under a DeviceMesh, on one world of 4 gloo ranks, held against
the JAX package.

JAX's own mesh checks (`tests/_par_worker.py`) fail on a jax with
explicit sharding (its jit needs `jax.set_mesh`), so the oracle is the
JAX functions called directly: the single-device `lm_loss` and AdamW
step, `sequential_apply`, and a vmap mean.  They run here, in the
pytest process; the ranks
(`tests/_torch_mesh_worker.py`, which imports no JAX) get the same numpy
weights and inputs and hand back numpy results, which the tests below
hold to the JAX worker's own tolerances:

  * dp (4,1), tp (1,4), dp_tp (2,2), fsdp (2,2): loss at rtol 1e-5,
    gradients at rtol 1e-4 / atol 1e-6, the post-AdamW parameters'
    relative squared difference below 1e-9; and the port's sharded step
    against its own unsharded one;
  * dp_tp with compressed gradients: the wire bit-equal to the unsharded
    wire on the same gradients, and the step against the unsharded
    compressed step from the same generator;
  * pp: pipeline_apply over 4 stages == sequential_apply, forward 1e-5,
    gradient 1e-4 / 1e-5;
  * smdp: the all-reduce mean == data_parallel's W-axis mean == JAX's
    vmap mean, 1e-5 / 1e-6;
  * the MoE, hybrid and ssm families' SMOKE forwards under dp_tp equal
    the unsharded forward at fp32 2e-5 (the MoE's expert choices first);
  * the vocab-parallel `lm_loss`: where the vocab is split (tp, dp_tp,
    fsdp) no op of the loss and its gradients outputs whole vocab rows
    (its values are the train step's above: loss rtol 1e-5, gradients
    rtol 1e-4 / atol 1e-6 against JAX and the unsharded port);
  * the mesh state saved by every rank (dp_tp, fsdp), blocking and
    asynchronous: the files of the same state saved whole, byte for
    byte, and a restore into the layout bit-equal;
  * two Adafactor steps under dp_tp and fsdp against the unsharded ones
    (the AdamW case's relative squared difference below 1e-9) and
    against JAX's `adafactor` on the same gradients (statistics at rtol
    1e-5; parameters at rtol 1e-5 with atol 1e-7, `test_torch_optim`'s
    fp32 atol: where the update cancels a parameter a few ulps of the
    update are a large share of it), its statistics placed as
    `state_specs` says;
  * the launcher's loop on a (2,2) mesh under every env with Adafactor,
    an asynchronous save every step and --trace-out: losses at rtol 1e-5
    of the unsharded loop's, rank 0 alone recording, its trace holding
    the unsharded run's events;
  * Adafactor on the mesh makes no split leaf whole: an update a leaf at
    a time under a watch finds no op whose local output has the whole
    leaf's shape;
  * `elastic_lm_loop` on (2,2) under dp_tp in all five modes over the
    sim transport, sync and async_ps also over proc, with one death, from
    JAX's weights: transitions, recoveries, final_alive and the
    checkpoint steps on disk exactly the unsharded loop's in the same
    world, losses at rtol 1e-5 (the sharded reductions reassociate); the
    sync runs also against JAX's `elastic_lm_loop` (run here, as
    `test_torch_elastic_lm.py` calls it);
  * an error of rank 0's transport (in `start`, in `role_call`) raised
    on every rank of the `RankZeroTransport`, each within seconds.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_threads import one_thread  # noqa: F401

from repro.configs import get_config as jax_config
from repro.core.pipeline import sequential_apply
from repro.models import model as JMD
from repro.models.config import ModelConfig
from repro.optim.optimizers import get_optimizer

CFG = ModelConfig(name="tiny", arch_type="dense", num_layers=2,
                  d_model=128, num_heads=8, num_kv_heads=4, d_ff=256,
                  vocab_size=512, param_dtype="float32",
                  compute_dtype="float32", remat="none")
B, S = 8, 32
FAMILIES = ("qwen3-moe-30b-a3b", "zamba2-1.2b", "rwkv6-1.6b")
WORLD = 4


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _init(cfg, seed):
    """Weights of JAX's descriptor tree drawn with numpy, as its
    init_model draws them (zeros, ones, or normal at 1/sqrt(fan_in) or
    0.02), without compiling a random init for every model."""
    from repro.models.common import ParamDesc
    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return getattr(np, d.init)(d.shape, np.float32)
        fan_in = d.fan_in or (d.shape[-2] if len(d.shape) >= 2
                              else d.shape[-1])
        scale = 0.02 if d.init == "small_normal" else fan_in ** -0.5
        return (rng.standard_normal(d.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map(draw, JMD.model_descs(cfg),
                                  is_leaf=lambda x: isinstance(x, ParamDesc))


def _jax_refs():
    rng = np.random.default_rng(0)
    params = _init(CFG, 0)
    batch = {k: rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    opt = get_optimizer("adamw", lambda s: 1e-2)

    def step(p, b):
        loss, g = jax.value_and_grad(JMD.lm_loss)(p, CFG, b)
        p2, _ = opt.update(g, opt.init(p), p)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(x))
                             for x in jax.tree_util.tree_leaves(g)))
        return loss, g, p2, gnorm

    loss, g, p1, gnorm = jax.jit(step)(params, batch)
    refs = {"params": params, "batch": batch, "loss": float(loss),
            "grads": _np(g), "p1": _np(p1), "gnorm": float(gnorm)}

    # pipeline: tests/_par_worker.py's stack and input, numpy drawn
    L, D = 8, 16
    refs["pp_stack"] = {"w": (rng.standard_normal((L, D, D)) * 0.3).astype(
        np.float32), "b": np.zeros((L, D), np.float32)}
    refs["pp_x"] = rng.standard_normal((16, D)).astype(np.float32)
    jstack = {k: jnp.asarray(v) for k, v in refs["pp_stack"].items()}

    def block_fn(lp, h):
        return jnp.tanh(h @ lp["w"] + lp["b"])

    x = jnp.asarray(refs["pp_x"])
    refs["pp_y"] = np.asarray(sequential_apply(block_fn, jstack, x))
    refs["pp_grads"] = _np(jax.grad(lambda s: jnp.sum(
        sequential_apply(block_fn, s, x) ** 2))(jstack))

    # shard_map data parallel's vmap-mean semantics
    refs["sm_xw"] = rng.standard_normal((WORLD, 4, D)).astype(np.float32)
    refs["sm_w0"] = (rng.standard_normal(D) * 0.1).astype(np.float32)
    refs["sm_yw"] = refs["sm_xw"].sum(-1).astype(np.float32)

    def loss_fn(w, xb, yb):
        return jnp.mean((xb @ w - yb) ** 2)

    refs["sm_vmap"] = np.asarray(jnp.mean(jax.vmap(
        lambda xb, yb: jax.grad(loss_fn)(jnp.asarray(refs["sm_w0"]), xb,
                                         yb))(refs["sm_xw"], refs["sm_yw"]),
        0))

    refs["families"] = FAMILIES
    refs["fam_tokens"] = rng.integers(0, 512, (4, 16)).astype(np.int32)
    for arch in FAMILIES:
        jcfg = jax_config(arch, smoke=True).with_(param_dtype="float32",
                                                 compute_dtype="float32")
        assert jcfg.vocab_size == 512, arch
        refs[f"fam_{arch}"] = _init(jcfg, 3)
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references, then one 4-rank world that runs every check;
    rank 0's results."""
    import torch.multiprocessing as mp
    import _torch_mesh_worker as W
    refs = _jax_refs()
    tmp = tmp_path_factory.mktemp("mesh")
    out = tmp / "results.pkl"
    mp.spawn(W.run, args=(WORLD, str(tmp / "store"), refs, str(out)),
             nprocs=WORLD, join=True)
    with open(out, "rb") as f:
        return refs, pickle.load(f)


def _result(world, name):
    refs, res = world
    r = res[name]
    assert "error" not in r, r.get("error")
    return refs, r


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("name", ["dp", "tp", "dp_tp", "fsdp"])
def test_train_step_equals_jax(world, name):
    refs, r = _result(world, name)
    np.testing.assert_allclose(r["loss"], refs["loss"], rtol=1e-5)
    for a, c in zip(_leaves(refs["grads"]), _leaves(r["grads"])):
        np.testing.assert_allclose(c, a, rtol=1e-4, atol=1e-6)
    assert _rel_sq_diff(refs["p1"], r["params"]) < 1e-9
    np.testing.assert_allclose(r["gnorm"], refs["gnorm"], rtol=1e-5)


@pytest.mark.parametrize("name", ["dp", "tp", "dp_tp", "fsdp"])
def test_train_step_equals_unsharded_port(world, name):
    _, r = _result(world, name)
    u = r["unsharded"]
    np.testing.assert_allclose(r["loss"], u["loss"], rtol=1e-6)
    for a, c in zip(_leaves(u["grads"]), _leaves(r["grads"])):
        np.testing.assert_allclose(c, a, rtol=1e-4, atol=1e-6)
    assert _rel_sq_diff(u["params"], r["params"]) < 1e-9


def _rel_sq_diff(ref, got):
    """The JAX worker's aggregate measure for post-AdamW parameters:
    1/sqrt(nu) amplifies gradient noise where nu ~ 0, so elements are
    not compared one by one."""
    num = sum(float(np.sum((a - c) ** 2)) for a, c in
              zip(_leaves(ref), _leaves(got)))
    return num / sum(float(np.sum(a ** 2)) for a in _leaves(ref))


def test_envs_place_as_their_specs(world):
    """The layouts differ by env: vocab rows of the embedding on the
    model axis under dp_tp, whole under dp, also split over data (FSDP,
    its d dim) under fsdp."""
    placed = {n: world[1][n]["placements"] for n in
              ("dp", "tp", "dp_tp", "fsdp")}
    assert placed["dp"]["embed"] == "(Replicate(), Replicate())"
    assert placed["dp_tp"]["embed"] == "(Replicate(), Shard(dim=0))"
    assert placed["fsdp"]["embed"] == "(Shard(dim=1), Shard(dim=0))"
    assert placed["tp"]["wq"] == "(Replicate(), Shard(dim=2))"


def test_compressed_dp_tp_wire_bit_equal(world):
    """Each rank packs its own elements with its slice of the whole
    leaf's uniforms: the sharded gradients through the sharded wire equal
    the same gradients, whole, through the unsharded wire, bit for bit."""
    _, r = _result(world, "dp_tp_nc")
    for a, c in zip(_leaves(r["rewired"]), _leaves(r["sharded"]["wired"])):
        np.testing.assert_array_equal(c, a)


def test_compressed_dp_tp_step_equals_unsharded(world):
    """The whole compressed step against the unsharded one from the same
    generator.  The gradients entering the wire differ by the sharded
    reduction's reassociation (rtol 1e-4), so an element whose uniform
    falls between the two inputs' rounding points takes the adjacent
    power of two (at most 1 in 10^4 elements, each a factor of exactly 2
    with its sign kept); every other wire element is bit-equal.  Off
    those elements the parameters and moments hold the JAX worker's
    aggregate measure; on them the moments follow the wire (mu by its
    ratio, nu by its square), and a parameter may move by up to lr.
    """
    _, r = _result(world, "dp_tp_nc")
    sh, un = r["sharded"], r["unsharded"]
    for a, c in zip(_leaves(un["grads"]), _leaves(sh["grads"])):
        np.testing.assert_allclose(c, a, rtol=1e-4, atol=1e-6)
    flips, total, same, ratio = 0, 0, [], []
    for a, c in zip(_leaves(un["wired"]), _leaves(sh["wired"])):
        d = a != c
        flips += int(d.sum())
        total += a.size
        same.append(~d)
        ratio.append(c[d] / a[d])
        assert set(np.abs(ratio[-1]).tolist()) <= {0.5, 2.0}
    print(f"compressed dp_tp: {flips} of {total} wire elements differ")
    assert flips <= total // 10_000
    for key in ("params", "mu", "nu"):
        kept = [(a[m], c[m]) for a, c, m in
                zip(_leaves(un[key]), _leaves(sh[key]), same)]
        assert _rel_sq_diff([a for a, _ in kept],
                            [c for _, c in kept]) < 1e-9, key
    for key, power in (("mu", 1), ("nu", 2)):
        for a, c, m, q in zip(_leaves(un[key]), _leaves(sh[key]), same,
                              ratio):
            np.testing.assert_allclose(c[~m] / a[~m], q ** power,
                                       rtol=1e-5)
    from _torch_mesh_worker import LR
    for a, c, m in zip(_leaves(un["params"]), _leaves(sh["params"]), same):
        assert np.all(np.abs(c[~m] - a[~m]) <= LR), "params"
    np.testing.assert_allclose(sh["loss"], un["loss"], rtol=1e-6)
    np.testing.assert_allclose(sh["gnorm"], un["gnorm"], rtol=1e-6)


def test_pipeline_equals_sequential(world):
    refs, r = _result(world, "pp")
    np.testing.assert_allclose(r["y"], refs["pp_y"], rtol=1e-5, atol=1e-5)
    for k in ("b", "w"):
        np.testing.assert_allclose(r["grads"][k], refs["pp_grads"][k],
                                   rtol=1e-4, atol=1e-5)


def test_allreduce_mean_equals_worker_mean(world):
    refs, r = _result(world, "smdp")
    np.testing.assert_allclose(r["allreduce"], r["dp_mean"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(r["allreduce"], refs["sm_vmap"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_under_dp_tp(world, arch):
    _, r = _result(world, arch)
    if arch == "qwen3-moe-30b-a3b":
        assert r["layers_routed"] > 0
        if r["flips"]:
            # reported, and the plain forward held on the sharded choices
            print(f"{arch}: {r['flips']} routing choices flipped")
            ref = r["forced_logits"]
        else:
            ref = r["plain_logits"]
    else:
        ref = r["plain_logits"]
    np.testing.assert_allclose(r["logits"], ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(r["aux"], r["plain_aux"], rtol=2e-5,
                               atol=2e-5)
    assert os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"


@pytest.mark.parametrize("name", ["dp", "tp", "dp_tp", "fsdp"])
def test_lm_loss_keeps_the_vocab_split(world, name):
    """Whole vocab rows of the logits appear only where no mesh dim
    splits the vocab (dp: there the count sees them)."""
    _, r = _result(world, name)
    if name == "dp":
        assert r["whole_vocab_ops"] > 0
    else:
        assert r["whole_vocab_ops"] == 0


STATE_ENVS = [("DP_TP_ENV", "dp_tp"), ("TRAIN_ENV", "fsdp")]


@pytest.mark.parametrize("env", [e for e, _ in STATE_ENVS],
                         ids=[i for _, i in STATE_ENVS])
def test_mesh_save_is_the_state_saved_whole(world, env):
    _, r = _result(world, f"ckpt_{env}")
    assert r["split"] > 0 and r["n_files"] > 1
    assert r["blocking_equal"] and r["async_equal"]
    assert r["restored_bit_equal"] and r["meta"] == {"step": 1}


@pytest.mark.parametrize("env", [e for e, _ in STATE_ENVS],
                         ids=[i for _, i in STATE_ENVS])
def test_adafactor_on_the_mesh_equals_unsharded_and_jax(world, env):
    refs, r = _result(world, f"adafactor_{env}")
    sh, un = r["sharded"], r["unsharded"]
    assert r["placed_as_specs"] and r["split_stats"] > 0
    assert sh["step"] == un["step"] == 2
    assert _rel_sq_diff(un["params"], sh["params"]) < 1e-9
    assert _rel_sq_diff(un["f"], sh["f"]) < 1e-9
    opt = get_optimizer("adafactor", lambda s: 1e-2)
    p = refs["params"]
    st = opt.init(p)
    update = jax.jit(opt.update)
    for g in sh["grads"]:
        p, st = update(g, st, p)
    for a, c in zip(_leaves(_np(p)), _leaves(sh["params"])):
        np.testing.assert_allclose(c, a, rtol=1e-5, atol=1e-7)
    for a, c in zip(_leaves(_np(st["f"])), _leaves(sh["f"])):
        np.testing.assert_allclose(c, a, rtol=1e-5)


@pytest.mark.parametrize("env", ["dp", "tp", "dp_tp", "fsdp"])
def test_launcher_loop_with_state_options_on_the_mesh(world, env):
    _, r = _result(world, f"launch_{env}")
    np.testing.assert_allclose(r["losses"]["mesh"], r["losses"]["plain"],
                               rtol=1e-5)
    assert r["rank_0_records"]
    assert r["steps"] == ["step_00000001", "step_00000002"]
    mesh, plain = r["events"]
    assert mesh == plain and any(e[0] == "ckpt.commit" for e in mesh)


@pytest.mark.parametrize("env", [e for e, _ in STATE_ENVS],
                         ids=[i for _, i in STATE_ENVS])
def test_adafactor_makes_no_split_leaf_whole(world, env):
    """The sharded run's second update, a leaf at a time: no op of it
    outputs a local tensor of a split leaf's whole shape (the update
    before this slice gathered each leaf whole on every rank)."""
    _, r = _result(world, f"adafactor_{env}")
    split, hits = r["watched"]
    assert split > 0 and hits == 0


ELASTIC_RUNS = ["sync-sim", "local_sgd-sim", "easgd-sim", "async_ps-sim",
                "ssp-sim", "sync-proc", "async_ps-proc"]


def _elastic(world, run):
    mode, transport = run.split("-")
    return _result(world, f"elastic_{mode}_{transport}")[1]


@pytest.mark.parametrize("run", ELASTIC_RUNS)
def test_elastic_loop_on_the_mesh_equals_unsharded(world, run):
    from _torch_mesh_worker import ELASTIC
    r = _elastic(world, run)
    mesh, plain = r["mesh"], r["plain"]
    steps, _, death = ELASTIC[run.split("-")[0]]
    for key in ("recoveries", "final_alive", "transitions", "steps"):
        assert mesh[key] == plain[key], key
    assert [x[:2] for x in mesh["recoveries"]] == [(death, 1)]
    assert mesh["final_alive"] == (0,) and len(mesh["steps"]) >= 2
    assert len(mesh["losses"]) == steps
    np.testing.assert_allclose(mesh["losses"], plain["losses"], rtol=1e-5)


@pytest.fixture(scope="module")
def jax_elastic(tmp_path_factory):
    """JAX's `elastic_lm_loop` in sync mode at the worker's settings, as
    the JAX launcher hands it over without a mesh."""
    import json

    from repro.data import make_pipeline
    from repro.elastic import driver as JD
    from repro.launch.steps import batch_abstract, make_train_step
    from repro.optim.optimizers import warmup_cosine
    import _torch_mesh_worker as W
    tmp = tmp_path_factory.mktemp("jax_elastic")
    steps, _, death = W.ELASTIC["sync"]
    trace = tmp / "trace.json"
    trace.write_text(json.dumps([{"step": death, "kind": "fail",
                                  "worker": 1}]))
    opt = get_optimizer("adamw", warmup_cosine(W.EL_LR, 20, steps))
    params = jax.tree_util.tree_map(jnp.asarray, _init(CFG, 0))
    batch_abs = batch_abstract(CFG, W.EL_B, W.EL_S)
    res = JD.elastic_lm_loop(
        args=W.elastic_args("sync", "sim", str(tmp / "ck"), str(trace)),
        cfg=CFG, step_fn=jax.jit(make_train_step(CFG, opt)), params=params,
        opt_state=jax.jit(opt.init)(params),
        bshard={k: None for k in batch_abs}, batch_abs=batch_abs,
        pipe_factory=lambda shard, num: make_pipeline(
            CFG.vocab_size, W.EL_B, W.EL_S, shard_id=shard,
            num_shards=num, seed=0),
        step0=0, opt=opt, loss_fn=lambda p, b: JMD.lm_loss(p, CFG, b))
    return {"losses": res["losses"], "final_alive": tuple(res["final_alive"]),
            "transitions": [tuple(t) for t in res["transitions"]],
            "recoveries": [(r.wall_step, r.worker, r.cause, r.lost_steps)
                           for r in res["recoveries"]],
            "steps": sorted(p.name for p in (tmp / "ck").glob("step_*"))}


@pytest.mark.parametrize("transport", ["sim", "proc"])
def test_elastic_sync_on_the_mesh_equals_jax(world, jax_elastic, transport):
    mesh = _elastic(world, f"sync-{transport}")["mesh"]
    for key in ("recoveries", "final_alive", "steps"):
        assert mesh[key] == jax_elastic[key], key
    assert [tuple(t) for t in mesh["transitions"]] == \
        jax_elastic["transitions"]
    np.testing.assert_allclose(mesh["losses"], jax_elastic["losses"],
                               rtol=1e-5)


@pytest.mark.parametrize("where", ["start", "role_call"])
def test_rank0_control_plane_error_raised_on_every_rank(world, where):
    _, r = _result(world, f"control_{where}")
    first = r["raised"][0]
    assert first is not None and r["raised"] == [first] * WORLD
    if where == "start":
        assert first[:2] == ("RuntimeError", "worker 1 did not start")
    else:
        assert first[0] == "RoleHostDied" and first[2:] == (2, "ps_pull")
    assert r["seconds"] < 30
