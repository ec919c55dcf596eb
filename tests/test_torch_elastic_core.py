"""The elastic core against the JAX package's: membership, resharding,
stacked checkpoints and their retention, the parameter-server and
replay-shard state, and the straggler / ETA model.

Both packages get the same numpy inputs and traces.  Transition logs,
`FailureTrace` JSON, `encode_entries`, PS shard state, replay samples,
DBS-based splits, backup decisions and stacked checkpoint files are
compared exactly; survivor rows are bit-exact and "mean" joiners equal
JAX's bit for bit (fp32 and bf16).
"""
import pathlib

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import ckpt as JCK  # noqa: E402
from repro.core import param_server as JPS  # noqa: E402
from repro.core import replay_shard as JRS  # noqa: E402
from repro.elastic import membership as JM  # noqa: E402
from repro.elastic import reshard as JR  # noqa: E402
from repro.elastic import straggler as JST  # noqa: E402
from repro_torch.checkpoint import AsyncCheckpointer  # noqa: E402
from repro_torch.checkpoint import ckpt as TCK  # noqa: E402
from repro_torch.core import param_server as PS  # noqa: E402
from repro_torch.core import replay_shard as RS  # noqa: E402
from repro_torch.elastic import membership as M  # noqa: E402
from repro_torch.elastic import reshard as R  # noqa: E402
from repro_torch.elastic import straggler as ST  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

# (trace events, num_workers, heartbeat_timeout, wall steps): the traces
# of tests/test_elastic.py's membership tests, and one of every kind
TRACES = {
    "replay": ([(3, "fail", 0, 1.0), (5, "hang", 1, 1.0),
                (10, "join", 7, 1.0), (12, "slow", 2, 0.25)], 4, 3, 15),
    "suspect_recover": ([(4, "hang", 1, 1.0), (6, "recover", 1, 1.0)],
                        2, 5, 8),
    "death_final": ([(2, "fail", 0, 1.0), (3, "recover", 0, 1.0),
                     (4, "join", 9, 1.0)], 3, 3, 6),
    "every_kind": ([(1, "slow", 0, 0.5), (2, "hang", 2, 1.0),
                    (2, "join", 1, 1.0), (3, "recover", 2, 1.0),
                    (5, "hang", 0, 1.0), (6, "fail", 1, 1.0),
                    (9, "join", 3, 1.0)], 3, 2, 12),
}


def _trace(mod, events):
    return mod.FailureTrace(mod.TraceEvent(s, k, w, r)
                            for s, k, w, r in events)


def _drive(mod, name):
    events, n, timeout, steps = TRACES[name]
    m = mod.Membership(n, _trace(mod, events), heartbeat_timeout=timeout)
    log = [tr.as_tuple() for t in range(steps) for tr in m.advance(t)]
    status = {w: (s.status, s.rate, s.hung, s.last_heartbeat)
              for w, s in m.workers.items()}
    return log, m.alive(), m.rates(), m.generation, status


@pytest.mark.parametrize("name", sorted(TRACES))
def test_membership_transition_log_equals_jax(name):
    assert _drive(M, name) == _drive(JM, name)


def test_failure_trace_json_byte_equal(tmp_path):
    events = TRACES["every_kind"][0]
    _trace(M, events).save(str(tmp_path / "t.json"))
    _trace(JM, events).save(str(tmp_path / "j.json"))
    assert ((tmp_path / "t.json").read_bytes()
            == (tmp_path / "j.json").read_bytes())
    # each package loads the other's file
    again = M.FailureTrace.load(str(tmp_path / "j.json"))
    assert [(e.step, e.kind, e.worker, e.rate) for e in again.events] == \
        [(e.step, e.kind, e.worker, e.rate)
         for e in JM.FailureTrace.load(str(tmp_path / "t.json")).events]
    with pytest.raises(ValueError, match="unknown event kind"):
        M.TraceEvent(0, "explode", 0)


# ---------------------------------------------------------------------------
# resharding
# ---------------------------------------------------------------------------
def _stacked_np(W, dim=6, seed=0):
    """A stacked params + AdamW-like state tree, fp32, bf16-valued and
    int32 leaves, from numpy."""
    rng = np.random.RandomState(seed)
    bf = rng.randn(W, 3, dim).astype(np.float32)
    bf = (bf.view(np.uint32) & 0xFFFF0000).view(np.float32)  # bf16 values
    return {"params": {"w": rng.randn(W, dim).astype(np.float32),
                       "e": bf},
            "opt": {"mu": {"w": rng.randn(W, dim).astype(np.float32)},
                    "step": np.arange(W, dtype=np.int32) + 3}}


def _to_torch(tree):
    out = tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    out["params"]["e"] = out["params"]["e"].to(torch.bfloat16)
    return out


def _to_jax(tree):
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["params"]["e"] = out["params"]["e"].astype(jnp.bfloat16)
    return out


def _np_leaves(tree):
    """Leaves of a tree of either package as numpy (sorted-key order),
    bf16 widened exactly to fp32."""
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            out.append((t.float() if t.dtype == torch.bfloat16 else t)
                       .numpy())
        else:
            a = np.asarray(t)
            out.append(a.astype(np.float32) if a.dtype.name == "bfloat16"
                       else a)
    return out


def _same(t_tree, j_tree):
    """Bit-equal leaves (bf16 compared through its exact fp32 widening)."""
    a, b = _np_leaves(t_tree), _np_leaves(j_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("old,new,init", [
    ([0, 1, 2, 3, 4], [0, 2, 4], "mean"),          # two deaths
    ([0, 2, 4], [0, 2, 4], "mean"),                # identity
    ([0, 1, 2], [0, 1, 2, 7, 8], "mean"),          # two joiners
    ([0, 1, 2], [2, 9, 0], "donor"),               # reorder + donor
    ([3, 5, 6], [5, 11], "zeros"),                 # a callable policy
])
def test_reshard_matches_jax(old, new, init):
    state = _stacked_np(len(old), seed=len(new))
    kw = {"donor": 2} if init == "donor" else {}
    t_init = init if init != "zeros" else torch.zeros_like
    j_init = init if init != "zeros" else jnp.zeros_like
    out_t = R.reshard_stacked(_to_torch(state), old, new, init=t_init, **kw)
    out_j = JR.reshard_stacked(_to_jax(state), old, new, init=j_init, **kw)
    _same(out_t, out_j)
    # survivor rows carry their bits, whatever the policy
    for wid in new:
        if wid in old:
            row_t = tree_map(lambda l: l[new.index(wid)], out_t)
            row_s = tree_map(lambda l: l[old.index(wid)], _to_torch(state))
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(row_t), tree_leaves(row_s)))
    taken = R.take_rows(_to_torch(state), [len(old) - 1, 0])
    _same(taken, JR.take_rows(_to_jax(state), [len(old) - 1, 0]))


def test_reshard_requires_a_survivor_and_unique_ids():
    p_w = {"w": torch.ones(2, 3)}
    with pytest.raises(ValueError, match="surviv"):
        R.reshard_stacked(p_w, [0, 1], [5, 6])
    with pytest.raises(ValueError, match="duplicate"):
        R.reshard_stacked(p_w, [0, 0], [0])
    with pytest.raises(ValueError, match="init policy"):
        R.reshard_stacked(p_w, [0, 1], [0, 2], init="median")


def test_assign_shards_matches_jax():
    for ids in ([0], [3, 1, 2], [9, 0, 4, 7]):
        assert R.assign_shards(ids) == JR.assign_shards(ids)


# ---------------------------------------------------------------------------
# stacked checkpoints: byte-identical files, restorable across packages
# ---------------------------------------------------------------------------
def _files(d):
    d = pathlib.Path(d)
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_save_stacked_byte_equal_and_cross_restore(tmp_path):
    state = _stacked_np(4)
    center = {"w": np.linspace(0, 1, 6, dtype=np.float32)}
    ids = [0, 1, 5, 7]
    R.save_stacked(str(tmp_path / "t"), 7, _to_torch(state), ids,
                   replicated=tree_map(torch.from_numpy, center),
                   metadata={"mode": "easgd"})
    JR.save_stacked(str(tmp_path / "j"), 7, _to_jax(state), ids,
                    replicated=jax.tree_util.tree_map(jnp.asarray, center),
                    metadata={"mode": "easgd"})
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert len(_files(tmp_path / "t")) == 6   # 5 leaves + the manifest

    new_ids = [1, 7, 9]
    row_t = tree_map(lambda l: l[0], _to_torch(state))
    row_j = jax.eval_shape(lambda: jax.tree_util.tree_map(
        lambda l: l[0], _to_jax(state)))
    # the port restores JAX's files and JAX restores the port's
    st_t, rep_t, meta_t = R.restore_stacked(
        str(tmp_path / "j"), row_t, new_ids,
        abstract_replicated=tree_map(torch.from_numpy, center))
    st_j, rep_j, meta_j = JR.restore_stacked(
        str(tmp_path / "t"), row_j, new_ids,
        abstract_replicated=jax.eval_shape(lambda: center))
    assert meta_t == meta_j == {"mode": "easgd", "worker_ids": ids}
    _same(st_t, st_j)
    _same(rep_t, rep_j)
    assert st_t["params"]["e"].dtype == torch.bfloat16
    assert st_t["opt"]["step"].dtype == torch.int32
    # survivors 1 and 7 are rows 1 and 3 of the saved state, bit for bit
    src = _to_torch(state)
    for a, b in zip(tree_leaves(st_t), tree_leaves(src)):
        assert torch.equal(a[:2], b[[1, 3]])
    st_all, _, _ = R.restore_stacked(str(tmp_path / "t"), row_t, ids)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(st_all), tree_leaves(src)))
    with pytest.raises(ValueError, match="row shape"):
        R.restore_stacked(str(tmp_path / "t"), {"params": {
            "w": torch.zeros(5), "e": torch.zeros(3, 6)},
            "opt": row_t["opt"]}, ids)


def test_save_stacked_through_async_checkpointer_byte_equal(tmp_path):
    state = _stacked_np(3)
    with AsyncCheckpointer(str(tmp_path / "a"), keep_last=2) as ck:
        for step in (1, 2, 3):
            R.save_stacked(str(tmp_path / "a"), step, _to_torch(state),
                           [0, 1, 2], checkpointer=ck)
        ck.wait()
    for step in (1, 2, 3):
        JR.save_stacked(str(tmp_path / "j"), step, _to_jax(state),
                        [0, 1, 2], keep_last=2)
    assert _files(tmp_path / "a") == _files(tmp_path / "j")
    assert sorted(p.name for p in (tmp_path / "a").glob("step_*")) == [
        "step_00000002", "step_00000003"]


# ---------------------------------------------------------------------------
# keep_last / floor (counterparts of tests/test_checkpoint_retention.py)
# ---------------------------------------------------------------------------
def _tree(pkg, v):
    if pkg == "jax":
        return {"w": jnp.full((3,), float(v), jnp.float32),
                "b": jnp.zeros((2,))}
    return {"w": torch.full((3,), float(v)), "b": torch.zeros(2)}


def _steps(d):
    return sorted(int(p.name.split("_")[1])
                  for p in pathlib.Path(d).glob("step_*"))


def _retention_script(pkg, d, saver):
    """The retention tests' save sequences, returning what is left."""
    save = JCK.save_checkpoint if pkg == "jax" else saver
    gc = JCK.gc_checkpoints if pkg == "jax" else TCK.gc_checkpoints
    left = []
    for s in (1, 2, 3, 4, 5):                   # newest by step number
        save(f"{d}/a", s, _tree(pkg, s), keep_last=3)
    left.append(_steps(f"{d}/a"))
    for s in (10, 2, 30, 7):                    # numeric, not lexical
        save(f"{d}/b", s, _tree(pkg, s))
    removed = gc(f"{d}/b", keep_last=2)
    left += [_steps(f"{d}/b"), [pathlib.Path(p).name for p in removed]]
    for s in (1, 2, 3):                         # a re-save counts once
        save(f"{d}/c", s, _tree(pkg, s), keep_last=3)
    save(f"{d}/c", 3, _tree(pkg, 33), keep_last=3)
    left.append(_steps(f"{d}/c"))
    for s in (10, 20, 30, 40):                  # the fleet rewind floor
        save(f"{d}/f", s, _tree(pkg, s))
    gc(f"{d}/f", keep_last=2, floor=15)
    left.append(_steps(f"{d}/f"))
    gc(f"{d}/f", keep_last=2, floor=99)
    left.append(_steps(f"{d}/f"))
    for s in (10, 20, 30, 40):                  # floor through the save
        save(f"{d}/g", s, _tree(pkg, s), keep_last=2, floor=15)
    left.append(_steps(f"{d}/g"))
    return left


def _async_save(d, step, tree, metadata=None, keep_last=0, floor=None):
    with AsyncCheckpointer(d, keep_last=keep_last,
                           floor_fn=lambda: floor) as ck:
        path = ck.save(step, tree, metadata)
        ck.wait()
    return path


@pytest.mark.parametrize("saver", ["blocking", "async"])
def test_keep_last_and_floor_match_jax(tmp_path, saver):
    save = TCK.save_checkpoint if saver == "blocking" else _async_save
    left = _retention_script("torch", tmp_path / "t", save)
    assert left == _retention_script("jax", tmp_path / "j", None)
    assert left == [[3, 4, 5], [10, 30], ["step_00000002", "step_00000007"],
                    [1, 2, 3], [10, 30, 40], [30, 40], [10, 30, 40]]
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


# ---------------------------------------------------------------------------
# parameter-server and replay-shard state
# ---------------------------------------------------------------------------
def _entries(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(5).astype(np.float64),     # cast to float32
            "s": np.float32(rng.randn())}


def test_encode_entries_equal_and_round_trip():
    e = _entries(0)
    wire = PS.encode_entries(e)
    assert wire == JPS.encode_entries(e)
    back = PS.decode_entries(JPS.encode_entries(e))
    for k, v in e.items():
        assert back[k].tobytes() == np.asarray(v, np.float32).tobytes()
    assert PS.shard_keys(list("edcba"), 2) == JPS.shard_keys(list("edcba"), 2)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_ps_shard_versions_and_values_match_jax(momentum):
    shards = [mod.PSShard(0.1, momentum=momentum) for mod in (PS, JPS)]
    for sh in shards:
        sh.init({"w": _entries(0)["w"], "b": _entries(0)["b"]})
    for i in range(5):
        g = _entries(10 + i)
        vs = [sh.push(i % 2, i // 2, {"w": g["w"], "b": g["b"]})
              for sh in shards]
        assert vs[0] == vs[1] == i + 1
    (vt, et), (vj, ej) = shards[0].pull(), shards[1].pull()
    assert vt == vj and et.keys() == ej.keys()
    assert all(et[k].tobytes() == ej[k].tobytes() for k in et)
    assert shards[0].clocks == shards[1].clocks == {0: 2, 1: 1}
    shards[0].forget(1)
    assert shards[0].clocks == {0: 2}


def test_ssp_clock_gate_matches_jax():
    for s in (None, 0, 1, 2):
        gates = [mod.SSPClockGate(s) for mod in (PS, JPS)]
        trail = [[], []]
        for g, out in zip(gates, trail):
            for w in (0, 1, 2):
                g.register(w)
            for w in (0, 0, 1, 0, 2, 0, 1, 0, 0):
                ok = g.can_advance(w)
                out.append((w, ok, g.advance(w) if ok else None,
                            g.min_clock(), g.gap(w)))
            g.drop(2)
            out.append((g.min_clock(), g.can_advance(0)))
        assert trail[0] == trail[1]
    with pytest.raises(ValueError):
        PS.SSPClockGate(-1)


def test_replay_shard_samples_equal_jax():
    shards = [mod.ReplayShard(16, alpha=0.7, beta=0.5, seed=3)
              for mod in (RS, JRS)]
    rng = np.random.RandomState(4)
    for n in (5, 7, 9):                           # wraps the ring
        items = {"obs": rng.randn(n, 3).astype(np.float32),
                 "act": rng.randint(0, 4, (n,)).astype(np.float32)}
        prios = rng.rand(n) * 3
        assert (shards[0].push(1, n, items, prios)
                == shards[1].push(1, n, items, prios))
    for seed in (0, 1, 99):
        (it, xt, wt), (ij, xj, wj) = (sh.sample(8, seed) for sh in shards)
        assert it.tolist() == ij.tolist()
        assert wt.tobytes() == wj.tobytes()
        assert all(xt[k].tobytes() == xj[k].tobytes() for k in xt)
        for sh in shards:
            sh.update(it[:4], np.arange(4) + seed)
    assert shards[0].stats() == shards[1].stats()
    stores = [mod.ParamStore() for mod in (RS, JRS)]
    assert [s.publish(_entries(1)) for s in stores] == [1, 1]
    (vt, et), (vj, ej) = stores[0].pull(), stores[1].pull()
    assert vt == vj and all(et[k].tobytes() == ej[k].tobytes() for k in et)
    prios = np.array([0.5, 3.0, 3.0, 0.1, 2.0, 0.5, 7.0])
    for n in (1, 2, 3):
        assert (RS.stratified_assign(prios, n).tolist()
                == JRS.stratified_assign(prios, n).tolist())


# ---------------------------------------------------------------------------
# straggler telemetry and the ETA model
# ---------------------------------------------------------------------------
def test_straggler_replan_matches_jax():
    outs = []
    for mod in (ST, JST):
        mon = mod.ThroughputMonitor()
        alive = (0, 1, 2, 3)
        trail = [mod.replan_on_straggle(mon, alive, 64)]
        for _ in range(2):
            mon.observe(2, 16, 64.0)          # worker 2 at 1/4 speed
            trail.append(mod.replan_on_straggle(mon, alive, 64))
        mon.set_rate(1, 0.3)
        trail.append(mod.replan_on_straggle(mon, alive, 63, multiple=1))
        mon.forget(2)
        trail.append(mod.replan_on_straggle(mon, alive, 64, threshold=0.9))
        split = trail[2][0]
        trail.append(mod.step_time(split, {0: 1.0, 1: 1.0, 2: 0.25,
                                           3: 1.0}, overhead=0.5))
        outs.append(trail)
    assert outs[0] == outs[1]
    assert outs[0][2][1] == (2,) and outs[0][2][0][2] < 16


def _decision(d):
    return None if d is None else (d.straggler, d.helper, d.rows,
                                   d.eta_primary, d.eta_backup, d.winner)


@pytest.mark.parametrize("suspects", [(), (2,), (0, 3), (0, 1, 2, 3)])
def test_predict_etas_and_plan_backup_match_jax(suspects):
    """test_speculation's ETA cases over a grid of splits, rates and
    slacks: the same ETAs and the same backup decision, or none."""
    fired = 0
    for rows in ((8, 8, 8, 8), (16, 8, 5, 3), (4, 4, 30, 4)):
        split = dict(enumerate(rows))
        for slow in (1.0, 0.6, 0.3, 0.05):
            rates = {0: 1.0, 1: 0.9, 2: 1.0, 3: slow}
            assert (ST.predict_etas(split, rates, suspects)
                    == JST.predict_etas(split, rates, suspects))
            for slack in (1.0, 1.2, 1.5, 3.0, 1e6):
                dt = ST.plan_backup(split, rates, slack=slack,
                                    suspects=suspects)
                dj = JST.plan_backup(split, rates, slack=slack,
                                     suspects=suspects)
                assert _decision(dt) == _decision(dj)
                fired += dt is not None
    assert fired > 0 or suspects == (0, 1, 2, 3)
    assert ST.plan_backup({0: 8}, {0: 0.1}, slack=1.0) is None
