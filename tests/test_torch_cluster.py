"""The cluster control plane (`repro_torch.cluster`) against the JAX
package's.

Under `SimTransport`: the coordinator's transition logs, epochs,
subscriptions, commit floors and placement equal JAX's coordinator on the
same traces (counterparts of tests/test_cluster.py's sim tests), the role
registry routes the built-in and custom roles, the backup ledger is
exactly-once and the speculator arbitrates as JAX's does (counterparts of
tests/test_speculation.py's ledger and arbitration tests), and the
coordinator's obs events equal JAX's in (ts, ph, name, cat, host, args)
on a counter clock.  Three cases spawn real worker processes through the
port's `ProcTransport` on the CPU: injected churn, an organic kill whose
captured trace replays under sim, and a custom role through
`role_modules`.
"""
import itertools
import os
import time

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import numpy as np  # noqa: E402
from _hyp_compat import given, settings, st  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.cluster import Coordinator as JCoordinator  # noqa: E402
from repro.cluster import SimTransport as JSim  # noqa: E402
from repro.cluster import roles as jroles  # noqa: E402
from repro.cluster.coordinator import Speculator as JSpeculator  # noqa: E402
from repro.elastic import membership as JM  # noqa: E402
from repro.elastic.straggler import BackupDecision as JDecision  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.cluster import (Coordinator, ProcTransport,  # noqa: E402
                                 SimTransport, roles)
from repro_torch.cluster.coordinator import Speculator  # noqa: E402
from repro_torch.cluster.roles import BackupLedger, dispatch  # noqa: E402
from repro_torch.elastic import membership as M  # noqa: E402
from repro_torch.elastic.straggler import BackupDecision  # noqa: E402

# tests/test_cluster.py's churn: a hang that recovers, a crash, a rejoin
# under a used id (remapped), a straggler
CHURN = [(2, "hang", 1, 1.0), (3, "recover", 1, 1.0), (5, "fail", 1, 1.0),
         (8, "join", 1, 1.0), (10, "slow", 0, 0.25)]


def _trace(mod, events=CHURN):
    return mod.FailureTrace(mod.TraceEvent(*e) for e in events)


def _pkg(jax_side):
    """(Coordinator, SimTransport, membership module) of one package."""
    return ((JCoordinator, JSim, JM) if jax_side
            else (Coordinator, SimTransport, M))


def _sim_run(jax_side, steps=14, events=CHURN, n=2):
    C, S, mod = _pkg(jax_side)
    seen, epochs = [], []
    with C(S(_trace(mod, events)), n, heartbeat_timeout=3) as c:
        for kind in ("death", "join", "suspect", "rate"):
            c.subscribe(kind, lambda tr, k=kind: seen.append(
                (k, tr.worker, c.alive())))
        for t in range(steps):
            c.advance(t)
            epochs.append((c.epoch, c.generation, c.suspects()))
        return (c.transition_log(), c.alive(), c.rates(), seen, epochs,
                c.monitor.ema)


# ---------------------------------------------------------------------------
# the coordinator under the simulated clock
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("events", [CHURN, [(2, "hang", 1, 1.0)],
                                    [(1, "fail", 1, 1.0),
                                     (3, "join", 1, 1.0)]],
                         ids=["churn", "hang_timeout", "rejoin"])
def test_coordinator_sim_equals_jax(events):
    out = _sim_run(False, events=events)
    assert out == _sim_run(True, events=events)
    # and the raw membership machine on the same trace
    m = M.Membership(2, _trace(M, events), heartbeat_timeout=3)
    assert out[0] == [tr.as_tuple() for t in range(14) for tr in m.advance(t)]


def test_epoch_bumps_only_on_membership_change():
    _, _, _, seen, epochs, _ = _sim_run(False)
    assert [e for e, _, _ in epochs] == [0] * 5 + [1] * 3 + [2] * 6
    # subscribers see the post-transition view
    assert [s for s in seen if s[0] != "rate"] == [
        ("suspect", 1, (0, 1)), ("death", 1, (0,)), ("join", 2, (0, 2))]


def test_subscribe_rejects_unknown_kind():
    with Coordinator(SimTransport(), 1) as c:
        with pytest.raises(ValueError, match="unknown transition kind"):
            c.subscribe("resurrect", lambda t: None)


def test_commit_floor_and_plan_split_match_jax():
    """Commit reports set the rewind floor (a dead host's report drops
    out, a stale one from a corpse is ignored), and the DBS split and
    backup plan come from the same telemetry, in both packages."""
    outs = []
    for jax_side in (False, True):
        C, S, mod = _pkg(jax_side)
        c = C(S(_trace(mod, [(1, "fail", 1, 1.0), (2, "slow", 2, 0.25)])),
              4)
        trail = []
        for h, s in ((0, 30), (1, 10), (2, 20), (3, 40)):
            c.report_commit(h, s)
        trail.append((c.rewind_step(), c.rewind_step(exclude=1)))
        c.transport.report_commit(0, 35)
        for t in range(3):
            c.advance(t)
        c.report_commit(1, 5)                   # from a corpse: dropped
        trail += [c.rewind_step(), c.committed_steps(),
                  c.plan_split(64), c.plan_split(64, alive=(0, 3))]
        split, _ = c.plan_split(60, threshold=0.0)
        d = c.plan_backup(split, slack=1.2)
        trail.append(None if d is None else (d.straggler, d.helper, d.rows,
                                             d.eta_primary, d.eta_backup))
        gate = c.clock_gate(1)
        for w in c.alive():
            gate.register(w)
        trail.append(sorted(gate.clocks))
        outs.append(trail)
    assert outs[0] == outs[1]
    assert outs[0][0] == (10, 20) and outs[0][1] == 20


def test_place_rows_moves_rows_to_the_one_device():
    class OneDevice(SimTransport):
        def host_devices(self):
            return {0: torch.device("cpu"), 1: torch.device("cpu")}

    class TwoDevices(SimTransport):
        def host_devices(self):
            return {0: "devA", 1: "devB"}

    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
    placed = Coordinator(OneDevice(), 2).place_rows(tree, [0, 1])
    assert placed is not tree and placed["w"].device.type == "cpu"
    assert torch.equal(placed["w"], tree["w"])
    assert Coordinator(TwoDevices(), 2).place_rows(tree, [0, 1]) is tree
    assert Coordinator(SimTransport(), 2).place_rows(tree, [0, 1]) is tree


# ---------------------------------------------------------------------------
# the role registry under the simulated clock
# ---------------------------------------------------------------------------
_ECHO_PLUGIN = """\
from repro_torch.cluster import roles

if roles.lookup("echo_ping") is None:
    roles.register(roles.RoleSpec(
        "echo", open_verb="echo_open",
        make=lambda cmd: {"tag": cmd["tag"], "hits": 0},
        verbs={"echo_ping": lambda st, cmd: {
            "tag": st["tag"],
            "hits": st.__setitem__("hits", st["hits"] + 1) or st["hits"],
            "x": cmd.get("x", 0) * 2}}))
"""


def _echo_role():
    exec(_ECHO_PLUGIN, {})


def test_sim_role_registry_routes_custom_role():
    _echo_role()
    sim = SimTransport(M.FailureTrace())
    sim.role_open(0, "echo", tag="a")
    assert sim.role_call(0, "echo_ping", {"x": 21}) == {
        "tag": "a", "hits": 1, "x": 42}
    assert sim.role_call(0, "echo_ping")["hits"] == 2
    with pytest.raises(ValueError, match="unknown role verb"):
        sim.role_call(0, "no_such_verb")
    with pytest.raises(KeyError, match="not open"):
        sim.role_call(1, "echo_ping")
    with pytest.raises(ValueError, match="already"):
        roles.register(roles.RoleSpec("echo", None, None, {}))
    with pytest.raises(ValueError, match="no open verb"):
        sim.role_open(0, "member")


def _role_traffic(sim, enc):
    """ps, replay and learner traffic through the sim transport."""
    rng = np.random.RandomState(0)
    w0 = {"w": rng.randn(4).astype(np.float32)}
    sim.ps_open(3, lr=0.5, entries=w0, momentum=0.5)
    out = [sim.ps_push(3, worker=0, clock=1, grads={"w": np.ones(4)}),
           sim.ps_push(3, worker=1, clock=1, grads=w0)]
    v, e = sim.ps_pull(3)
    out += [v, e["w"].tobytes(), sim.role_call(3, "ps_pull")["version"]]
    sim.role_open(4, "replay", capacity=8, seed=2)
    items = {"obs": rng.randn(6, 2).astype(np.float32)}
    out.append(sim.role_call(4, "replay_push", {
        "items": enc(items), "priorities": [1, 2, 3, 4, 5, 6]}))
    out.append(sim.role_call(4, "replay_sample", {"batch": 5, "seed": 7}))
    out.append(sim.role_call(4, "replay_update", {
        "idx": [0, 1], "priorities": [9.0, 0.1]}))
    out.append(sim.role_call(4, "replay_stats"))
    sim.role_open(5, "learner", entries=enc(w0))
    out.append(sim.role_call(5, "learner_publish", {"entries": enc(w0)}))
    out.append(sim.role_call(5, "learner_pull"))
    return out


def test_built_in_roles_reply_as_jax():
    from repro.core.param_server import encode_entries as jenc
    from repro_torch.core.param_server import encode_entries as tenc
    assert (_role_traffic(SimTransport(M.FailureTrace()), tenc)
            == _role_traffic(JSim(JM.FailureTrace()), jenc))


# ---------------------------------------------------------------------------
# speculation: the ledger and the arbitration
# ---------------------------------------------------------------------------
@settings(max_examples=10, deadline=None)
@given(st.integers(0, 9))
def test_ledger_exactly_once_under_any_interleaving(seed):
    """Shuffled commits / cancels / duplicate launches: one resolution
    ever succeeds, and the port's ledger replies as JAX's, op by op."""
    import random

    states = {"backup": BackupLedger()}
    jstates = {"backup": jroles.BackupLedger()}
    launch = {"v": "backup_launch", "task": "0:5:3", "rows": 8}
    assert dispatch(states, launch) == jroles.dispatch(jstates, launch)
    ops = ["backup_commit"] * 2 + ["backup_cancel"] * 2 + ["backup_launch"]
    random.Random(seed).shuffle(ops)
    wins = discards = 0
    for v in ops:
        cmd = {"v": v, "task": "0:5:3", "rows": 8}
        reply = dispatch(states, cmd)
        assert reply == jroles.dispatch(jstates, cmd)
        wins += int(bool(reply.get("won")))
        discards += int(bool(reply.get("discarded")))
        assert not reply.get("accepted")
    assert wins + discards == 1
    # late messages after the resolution: refused, state unchanged
    for v in ("backup_commit", "backup_cancel", "backup_stats"):
        cmd = {"v": v, "task": "0:5:3"}
        assert dispatch(states, cmd) == jroles.dispatch(jstates, cmd)
    assert states["backup"].tasks == jstates["backup"].tasks == {
        "0:5:3": "won" if wins else "discarded"}


def test_speculator_resolve_matches_arbitration_both_orders():
    for eta_p, eta_b, expect in ((4.0, 9.0, "primary"),
                                 (9.0, 4.0, "backup"),
                                 (4.0, 4.0, "primary")):
        outs = []
        for C, S, Spec, D in ((Coordinator, SimTransport, Speculator,
                               BackupDecision),
                              (JCoordinator, JSim, JSpeculator, JDecision)):
            dec = D(straggler=1, helper=0, rows=8, eta_primary=eta_p,
                    eta_backup=eta_b)
            with C(S(), 2) as c:
                spec = Spec(c)
                launched = spec.launch(dec, step=5)
                relaunched = spec.launch(dec, step=5)    # duplicate
                won = spec.resolve(dec, step=5, winner=dec.winner)
                outs.append((dec.winner, launched, relaunched, won,
                             c.transport.role_call(0, "backup_stats"),
                             spec.stats()))
        assert outs[0] == outs[1]
        assert outs[0][0] == expect and outs[0][3] == (expect == "backup")


# ---------------------------------------------------------------------------
# obs: the coordinator's events on a counter clock
# ---------------------------------------------------------------------------
def _key(e):
    return (e.ts, e.ph, e.name, e.cat, e.host, e.args)


def _recorded(jax_side):
    C, S, mod = _pkg(jax_side)
    ob = jobs if jax_side else tobs
    Spec, D = ((JSpeculator, JDecision) if jax_side
               else (Speculator, BackupDecision))
    rec = ob.Recorder(clock=itertools.count().__next__)
    with ob.recording(rec):
        with C(S(_trace(mod)), 2, heartbeat_timeout=3) as c:
            for t in range(7):
                c.advance(t)
            c.report_commit(0, 10)
            c.report_commit(2, 4)
            c.transport.report_commit(0, 12)
            for t in range(7, 14):
                c.advance(t)
            spec = Spec(c)
            for i, (p, b) in enumerate(((9.0, 4.0), (4.0, 9.0))):
                dec = D(straggler=2, helper=0, rows=6, eta_primary=p,
                        eta_backup=b)
                spec.launch(dec, step=20 + i)
                spec.resolve(dec, step=20 + i, winner=dec.winner)
            c.transport.ps_open(3, lr=0.1, entries={"w": np.ones(2)})
            c.transport.ps_push(3, worker=0, clock=1,
                                grads={"w": np.ones(2)})
    return rec


def test_coordinator_obs_events_equal_jax():
    trec, jrec = _recorded(False), _recorded(True)
    assert [_key(e) for e in trec.events] == [_key(e) for e in jrec.events]
    names = {e.name for e in trec.events}
    for want in ("membership.death", "membership.join", "membership.rate",
                 "membership.suspect", "epoch", "commit.report",
                 "backup.launch", "backup.win", "backup.discard",
                 "ps.open", "ps.push"):
        assert want in names, want
    assert trec.metrics() == jrec.metrics()
    assert tobs.trace_json(trec.events) == jobs.trace_json(jrec.events)


# ---------------------------------------------------------------------------
# ProcTransport: real worker processes on the CPU (three cases)
# ---------------------------------------------------------------------------
def _drive(c, start, end):
    for t in range(start, end):
        c.advance(t)
    return c.transition_log()


def test_proc_injected_churn_log_equals_jax_sim():
    """CHURN actuated against 2 real worker processes: the transition log
    equals JAX's coordinator on the simulated clock, the captured trace
    is the injected one, the rejoined host reports its commits under its
    remapped id, and place_rows keeps the values on the hosts' device."""
    with JCoordinator(JSim(_trace(JM)), 2, heartbeat_timeout=3) as c:
        jax_log = _drive(c, 0, 14)
    proc = ProcTransport(inject=_trace(M), device="cpu")
    with Coordinator(proc, 2, heartbeat_timeout=3) as c:
        assert _drive(c, 0, 14) == jax_log
        assert c.alive() == (0, 2)
        assert [(e.step, e.kind, e.worker, e.rate)
                for e in proc.captured_trace().events] == CHURN
        assert proc.host_devices() == {0: torch.device("cpu"),
                                       2: torch.device("cpu")}
        proc.set_commit(2, 17)
        deadline = time.time() + 10
        while 2 not in c.committed_steps() and time.time() < deadline:
            c.advance(c.membership._last_step + 1)
        assert c.committed_steps() == {2: 17}
        tree = {"w": torch.arange(12.0).reshape(2, 6)}
        placed = c.place_rows(tree, [0, 2])
        assert placed is not tree and torch.equal(placed["w"], tree["w"])


def test_proc_organic_kill_capture_replays_under_sim():
    """A worker SIGKILLed from outside is observed as a fail; the
    captured trace replays under sim (the port's and JAX's) to the same
    log."""
    proc = ProcTransport(device="cpu")
    with Coordinator(proc, 3, heartbeat_timeout=3) as c:
        _drive(c, 0, 2)
        proc.kill_worker(1)
        live = _drive(c, 2, 8)
        captured = proc.captured_trace()
    assert (2, "death", 1, "fail", 1.0) in live
    with Coordinator(SimTransport(captured), 3, heartbeat_timeout=3) as c2:
        assert _drive(c2, 0, 8) == live
    events = [(e.step, e.kind, e.worker, e.rate) for e in captured.events]
    with JCoordinator(JSim(_trace(JM, events)), 3,
                      heartbeat_timeout=3) as c3:
        assert _drive(c3, 0, 8) == live


def test_proc_custom_role_through_role_modules(tmp_path, monkeypatch):
    _echo_role()                          # the driver side
    (tmp_path / "torch_echo_role.py").write_text(_ECHO_PLUGIN)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    proc = ProcTransport(role_modules=["torch_echo_role"], device="cpu")
    with Coordinator(proc, 2):
        proc.role_open(1, "echo", tag="b")
        assert proc.role_call(1, "echo_ping", {"x": 5}) == {
            "tag": "b", "hits": 1, "x": 10}
        with pytest.raises(KeyError, match="not open"):
            proc.role_call(0, "echo_ping")
        proc.ps_open(0, lr=0.5, entries={"w": np.ones(2, np.float32)})
        assert proc.ps_push(0, 1, 1, {"w": np.ones(2)}) == 1
        assert proc.ps_pull(0)[1]["w"].tolist() == [0.5, 0.5]
        with pytest.raises(ValueError, match="never reused"):
            proc.spawn_worker(1)


def test_proc_worker_reads_a_long_command_in_linear_time():
    """The worker's command lines (`proc._Lines`): lines split across
    chunks and several lines in one chunk come back whole and in order,
    and a 128 MiB line fed in 64 KiB pipe reads costs one pass (an
    accumulated buffer searched again at every read costs 2048 passes
    over up to 128 MiB: minutes, and hours at a model's gigabyte)."""
    from repro_torch.cluster.proc import _Lines
    lines = _Lines()
    assert lines.feed(b'{"v": "a"}\n{"v"') == [b'{"v": "a"}']
    assert lines.feed(b': "b"}') == []
    assert lines.feed(b'\n\n{"v": "c"}\nx') == [b'{"v": "b"}', b'',
                                                 b'{"v": "c"}']
    assert lines.feed(b"y\n") == [b"xy"]
    chunk = b"x" * (1 << 16)
    t0 = time.perf_counter()
    for _ in range(2048):
        assert lines.feed(chunk) == []
    (line,) = lines.feed(b"\n")
    assert len(line) == 1 << 27 and time.perf_counter() - t0 < 10.0
