"""Role/verb registry: how member hosts grow server duties.

The port of the JAX package's ``cluster/roles.py``: the same roles,
verbs and handlers, on the port's copies of ``core.param_server`` and
``core.replay_shard``.

A *role* is extra state a member host can serve besides heartbeating —
a parameter-server shard, a replay-buffer shard, a learner's published
parameters.  The registry is the transports' dispatch generalized, so
a new role plugs in WITHOUT editing transport internals:

  * `RoleSpec(name, open_verb, make, verbs)` declares a role: `make`
    builds the server-side state from the open command's payload, and
    each verb handler is `handler(state, cmd) -> reply dict`.
  * `SimTransport.role_open/role_call` runs `make`/handlers in-process
    against the simulated clock.
  * `ProcTransport` ships the same commands over the worker pipe; the
    child's `_worker_entry` loop dispatches through THIS registry, so
    the identical handler code runs behind a real process boundary.

Handlers speak the wire format on both transports: every array payload
rides as the `core.param_server.encode_entries` base64-float32 codec
(an exact round-trip), and everything else must be line-JSON-safe.
That is what makes sim and proc runs bit-identical — the handler never
sees different bytes depending on where it runs.

The built-in "member" role holds the knobs every worker already served
(hang / recover / slow / commit / obs_pull); `die` and `stop` remain
control-flow in the worker loop (they terminate it).  "ps", "replay",
and "learner" are the server roles (see `core.param_server` and
`core.replay_shard`).

Stdlib-only at module scope: this module is imported by the proc
transport's worker children, which must not pay the numpy/torch import
until a role that needs it is actually opened.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

Handler = Callable[[Any, Dict[str, Any]], Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class RoleSpec:
    """One role's server-side contract.

    open_verb/make may be None for roles whose state the host seeds
    itself (the "member" role exists from the first heartbeat)."""
    name: str
    open_verb: Optional[str]
    make: Optional[Callable[[Dict[str, Any]], Any]]
    verbs: Dict[str, Handler]


_ROLES: Dict[str, RoleSpec] = {}
_VERBS: Dict[str, Tuple[RoleSpec, Optional[Handler]]] = {}


def register(spec: RoleSpec) -> RoleSpec:
    """Register a role; its verbs become routable on every transport.
    Verb names are global (they arrive as bare strings on a pipe), so
    collisions are an error, not a shadow."""
    if spec.name in _ROLES:
        raise ValueError(f"role {spec.name!r} already registered")
    claimed = ([spec.open_verb] if spec.open_verb else []) + list(spec.verbs)
    for verb in claimed:
        if verb in _VERBS:
            raise ValueError(f"verb {verb!r} already claimed by role "
                             f"{_VERBS[verb][0].name!r}")
    _ROLES[spec.name] = spec
    if spec.open_verb:
        _VERBS[spec.open_verb] = (spec, None)   # None handler = open
    for verb, fn in spec.verbs.items():
        _VERBS[verb] = (spec, fn)
    return spec


def get(name: str) -> RoleSpec:
    if name not in _ROLES:
        raise KeyError(f"unknown role {name!r} (registered: "
                       f"{sorted(_ROLES)})")
    return _ROLES[name]


def lookup(verb: str) -> Optional[Tuple[RoleSpec, Optional[Handler]]]:
    """(spec, handler) for a verb; handler None means it is the role's
    open verb.  None for verbs no role claims."""
    return _VERBS.get(verb)


def dispatch(states: Dict[str, Any], cmd: Dict[str, Any]) -> Dict[str, Any]:
    """Shared server-side dispatch (worker child AND sim transport):
    route `cmd` ({"v": verb, ...}) to its role handler against the
    host's per-role `states`.  Open verbs construct the state; unknown
    verbs ack with an "err" payload rather than wedging the pipe."""
    verb = cmd["v"]
    hit = lookup(verb)
    if hit is None:
        return {"err": f"unknown verb {verb!r}"}
    spec, handler = hit
    if handler is None:                      # the role's open verb
        states[spec.name] = spec.make(
            {k: v for k, v in cmd.items() if k != "v"})
        return {}
    state = states.get(spec.name)
    if state is None:
        return {"err": f"role {spec.name!r} not open on this host"}
    return handler(state, cmd)


# ---------------------------------------------------------------------------
# built-in role: "member" — the base heartbeat duties every worker serves
# ---------------------------------------------------------------------------
class MemberState:
    """Mutable cell the worker loop shares with the member verbs: the
    beat emitter reads rate/hung/committed; obs_pull reads the flight
    ring."""

    def __init__(self, wid: int, flight: Any):
        self.wid = wid
        self.flight = flight
        self.rate = 1.0
        self.hung = False
        self.committed: Optional[int] = None


def _member_hang(m: MemberState, cmd: Dict) -> Dict:
    m.hung = True
    return {}


def _member_recover(m: MemberState, cmd: Dict) -> Dict:
    m.hung, m.rate = False, 1.0
    return {}


def _member_slow(m: MemberState, cmd: Dict) -> Dict:
    m.rate = float(cmd["rate"])
    return {}


def _member_commit(m: MemberState, cmd: Dict) -> Dict:
    m.committed = int(cmd["step"])
    return {}


def _member_obs_pull(m: MemberState, cmd: Dict) -> Dict:
    return {"events": m.flight.snapshot()}


register(RoleSpec("member", open_verb=None, make=None, verbs={
    "hang": _member_hang,
    "recover": _member_recover,
    "slow": _member_slow,
    "commit": _member_commit,
    "obs_pull": _member_obs_pull,
}))


# ---------------------------------------------------------------------------
# role: "ps" — versioned-KV parameter-server shard (core.param_server)
# ---------------------------------------------------------------------------
def _ps_make(cmd: Dict) -> Any:
    from repro_torch.core.param_server import PSShard, decode_entries
    ps = PSShard(cmd["lr"], momentum=cmd.get("momentum", 0.0))
    ps.init(decode_entries(cmd["entries"]))
    return ps


def _ps_push(ps: Any, cmd: Dict) -> Dict:
    from repro_torch.core.param_server import decode_entries
    return {"version": ps.push(cmd["worker"], cmd["clock"],
                               decode_entries(cmd["grads"]))}


def _ps_pull(ps: Any, cmd: Dict) -> Dict:
    from repro_torch.core.param_server import encode_entries
    version, entries = ps.pull()
    return {"version": version, "entries": encode_entries(entries)}


register(RoleSpec("ps", open_verb="ps_open", make=_ps_make, verbs={
    "ps_push": _ps_push,
    "ps_pull": _ps_pull,
}))


# ---------------------------------------------------------------------------
# role: "replay" — prioritized trajectory shard (core.replay_shard)
# ---------------------------------------------------------------------------
def _replay_make(cmd: Dict) -> Any:
    from repro_torch.core.replay_shard import ReplayShard
    return ReplayShard(cmd["capacity"], alpha=cmd.get("alpha", 0.6),
                       beta=cmd.get("beta", 0.4), seed=cmd.get("seed", 0))


def _replay_push(shard: Any, cmd: Dict) -> Dict:
    import numpy as np
    from repro_torch.core.param_server import decode_entries
    version = shard.push(cmd.get("actor", -1), cmd.get("clock", 0),
                         decode_entries(cmd["items"]),
                         np.asarray(cmd["priorities"], np.float64))
    return {"version": version, "size": shard.size}


def _replay_sample(shard: Any, cmd: Dict) -> Dict:
    from repro_torch.core.param_server import encode_entries
    idx, items, weights = shard.sample(cmd["batch"], cmd["seed"])
    # weights ride inside the entries codec under a reserved key so the
    # whole batch is one exact float32 round-trip
    items = dict(items)
    items["__weights__"] = weights
    return {"idx": [int(i) for i in idx], "size": shard.size,
            "entries": encode_entries(items)}


def _replay_update(shard: Any, cmd: Dict) -> Dict:
    import numpy as np
    shard.update(np.asarray(cmd["idx"], np.int64),
                 np.asarray(cmd["priorities"], np.float64))
    return {"version": shard.version}


def _replay_stats(shard: Any, cmd: Dict) -> Dict:
    return shard.stats()


register(RoleSpec("replay", open_verb="replay_open", make=_replay_make,
                  verbs={
    "replay_push": _replay_push,
    "replay_sample": _replay_sample,
    "replay_update": _replay_update,
    "replay_stats": _replay_stats,
}))


# ---------------------------------------------------------------------------
# role: "backup" — speculative-execution ledger on the helper host
# ---------------------------------------------------------------------------
class BackupLedger:
    """Exactly-once arbitration for speculative shard re-execution.

    The DRIVER picks the winner (a deterministic ETA compare on the
    simulated clock — `elastic.straggler.BackupDecision.winner`); this
    ledger makes that decision safe under the proc transport's real
    races: a task resolves at most once, and every verb is an
    idempotent no-op afterwards, so a duplicated or late message can
    never double-apply a backup's gradient contribution.  Task keys are
    `generation:step:shard`, so a decision that survives a membership
    change is fenced out by the generation bump."""

    INFLIGHT, WON, DISCARDED = "inflight", "won", "discarded"

    def __init__(self):
        self.tasks: Dict[str, str] = {}


def _backup_make(cmd: Dict) -> Any:
    return BackupLedger()


def _backup_launch(led: BackupLedger, cmd: Dict) -> Dict:
    task = cmd["task"]
    if task in led.tasks:                    # duplicate launch: refused
        return {"accepted": False, "state": led.tasks[task]}
    led.tasks[task] = led.INFLIGHT
    return {"accepted": True, "state": led.INFLIGHT}


def _backup_commit(led: BackupLedger, cmd: Dict) -> Dict:
    task = cmd["task"]
    if led.tasks.get(task) != led.INFLIGHT:  # unknown or already resolved
        return {"won": False, "state": led.tasks.get(task, "unknown")}
    led.tasks[task] = led.WON
    return {"won": True, "state": led.WON}


def _backup_cancel(led: BackupLedger, cmd: Dict) -> Dict:
    task = cmd["task"]
    if led.tasks.get(task) != led.INFLIGHT:
        return {"discarded": False,
                "state": led.tasks.get(task, "unknown")}
    led.tasks[task] = led.DISCARDED
    return {"discarded": True, "state": led.DISCARDED}


def _backup_stats(led: BackupLedger, cmd: Dict) -> Dict:
    states = list(led.tasks.values())
    return {"tasks": len(states),
            "inflight": states.count(led.INFLIGHT),
            "won": states.count(led.WON),
            "discarded": states.count(led.DISCARDED)}


register(RoleSpec("backup", open_verb="backup_open", make=_backup_make,
                  verbs={
    "backup_launch": _backup_launch,
    "backup_commit": _backup_commit,
    "backup_cancel": _backup_cancel,
    "backup_stats": _backup_stats,
}))


# ---------------------------------------------------------------------------
# role: "learner" — published-parameters store actors pull from
# ---------------------------------------------------------------------------
def _learner_make(cmd: Dict) -> Any:
    from repro_torch.core.param_server import decode_entries
    from repro_torch.core.replay_shard import ParamStore
    store = ParamStore()
    if cmd.get("entries"):
        store.publish(decode_entries(cmd["entries"]))
    return store


def _learner_publish(store: Any, cmd: Dict) -> Dict:
    from repro_torch.core.param_server import decode_entries
    return {"version": store.publish(decode_entries(cmd["entries"]))}


def _learner_pull(store: Any, cmd: Dict) -> Dict:
    from repro_torch.core.param_server import encode_entries
    version, entries = store.pull()
    return {"version": version, "entries": encode_entries(entries)}


register(RoleSpec("learner", open_verb="learner_open", make=_learner_make,
                  verbs={
    "learner_publish": _learner_publish,
    "learner_pull": _learner_pull,
}))
