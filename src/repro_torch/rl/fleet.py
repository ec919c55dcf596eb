"""Ape-X/IMPALA actor–learner fleet on the cluster control plane.

The port of the JAX package's ``rl/fleet.py``.  The survey's distributed
deep-RL architectures (GORILA ref 98, IMPALA ref 101, Ape-X ref 104)
share one shape: N *actors* roll out with periodically-pulled STALE
parameters and feed a (prioritized) replay service, while a central
*learner* consumes batches, corrects for the off-policy gap, and
publishes fresh parameters.  Here they are membership-tracked roles on
the port's cluster control plane:

  host ids 0..A-1        actors (lost throughput on death — elastic by
                         construction, nothing to rewind)
  host ids A..A+R-1      replay shards (`core.replay_shard.ReplayShard`
                         behind the "replay" role): trajectories are
                         dealt across shards by priority-stratified key
                         (`stratified_assign`), so a killed shard
                         degrades sampling coverage, not a priority band
  host id  A+R           the learner's published-params store (the
                         "learner" role): `learner_publish` bumps the
                         version actors `learner_pull`; its death is
                         fatal — it holds the canonical parameters

Both transports drive the same loop: `SimTransport` replays a failure
trace on the simulated clock, `ProcTransport` backs every role with a
real child process and ships the identical command stream over the
heartbeat pipes.  All role payloads ride the exact float32 wire codec
on the host, and replay sampling is seeded by the requester, so the
learner's loss trajectory is the same float for float on either.

The actor and learner math runs on ``device`` (the CUDA card unless the
CPU is asked for).  An actor's Gumbel draws for its n-th rollout come
from a CPU generator seeded by (seed, actor id, n), so they are the same
on every device and transport; ``run_fleet(noise=fn)`` takes them from
``fn(wid, n)`` instead.

Time model: one wall step is one fleet round of 1.0 simulated time
units; a slow actor accrues fractional rate credit and acts in fewer
rounds.  goodput = env steps collected / simulated time.

Obs spine: `actor.rollout` spans per acting actor, replay push/sample
spans on the shard lanes (via the transport role dispatch),
`learner.step` spans, an `rl.staleness` gauge, and per-role flight rings
pulled over the ack channel at the end of a proc run — the JAX
package's names and lanes, on the simulated clock.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint.ckpt import _flatten, _unflatten_like
from repro_torch.cluster import Coordinator, SimTransport
from repro_torch.cluster.transport import RoleHostDied
from repro_torch.core.param_server import decode_entries, encode_entries
from repro_torch.core.replay_shard import stratified_assign
from repro_torch.elastic.membership import FailureTrace
from repro_torch.obs import log
from repro_torch.obs import recorder as obs
from repro_torch.rl.agents import (_sgd, ac_init, impala_losses,
                                   policy_logits, value, value_and_grad)
from repro_torch.rl.env import ChainEnv, episode_return, gumbel, rollout

Pytree = Any
NoiseFn = Callable[[int, int], Any]


def _to_entries(params) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in _flatten(params).items()}


def actor_draws(seed: int, wid: int, acts: int, rollout_len: int,
                num_actions: int) -> torch.Tensor:
    """The Gumbel draws of actor `wid`'s `acts`-th rollout in a fleet
    seeded `seed`: (rollout_len, num_actions) on the CPU."""
    g = torch.Generator().manual_seed(
        int(np.random.SeedSequence((seed + 1, wid, acts))
            .generate_state(1, np.uint64)[0] >> 1))
    return gumbel((rollout_len, num_actions), g)


# ---------------------------------------------------------------------------
# actor/learner math
# ---------------------------------------------------------------------------
@torch.no_grad()
def _act(params, env_state, noise, *, env: ChainEnv, rollout_len: int,
         gamma: float):
    """One rollout under (stale) `params` plus the Ape-X initial
    priority: mean |1-step TD error| under the actor's own value head."""
    nstate, traj = rollout(env, params, policy_logits, env_state, noise,
                           rollout_len)
    boot_obs = env.obs(nstate)
    v = value(params, traj["obs"])
    boot = value(params, boot_obs)
    disc = gamma * (1.0 - traj["done"])
    v_tp1 = torch.cat([v[1:], boot[None]])
    td = traj["reward"] + disc * v_tp1 - v
    return nstate, traj, boot_obs, torch.mean(torch.abs(td))


def _learn(params, batch, is_w, *, gamma: float, lr: float,
           entropy_coef: float, value_coef: float):
    """One V-trace-corrected update from a replay batch of whole
    trajectories (leaves (B, T, ...), `boot_obs` (B, obs)).  Returns
    (new params, scalar loss, per-trajectory |vs - V| — the fresh
    priorities the learner writes back to the shards)."""
    def total(p):
        losses, prios = impala_losses(
            p, batch, batch["boot_obs"], gamma=gamma,
            entropy_coef=entropy_coef, value_coef=value_coef)
        return torch.mean(is_w * losses), prios

    (loss, prios), grads = value_and_grad(total, params, has_aux=True)
    return _sgd(params, grads, lr), loss, prios


# ---------------------------------------------------------------------------
# the three fleet entry points
# ---------------------------------------------------------------------------
class ReplayService:
    """Client view of the sharded replay service: opens the "replay"
    role on each shard host, deals pushes across shards by
    priority-stratified key, samples proportionally from every
    surviving shard, and writes priority updates back.  A shard that
    dies (membership death, or `RoleHostDied` mid-call) is dropped —
    its items are lost, sampling degrades to the survivors."""

    def __init__(self, transport, shard_ids: List[int], *, capacity: int,
                 alpha: float = 0.6, beta: float = 0.4, seed: int = 0):
        if not shard_ids:
            raise ValueError("need at least one replay shard")
        self.transport = transport
        self.alive: List[int] = sorted(shard_ids)
        self._sizes: Dict[int, int] = {}
        for i, sid in enumerate(self.alive):
            transport.role_open(sid, "replay", capacity=capacity,
                                alpha=alpha, beta=beta, seed=seed + i)
            self._sizes[sid] = 0

    def drop(self, sid: int) -> None:
        if sid in self.alive:
            self.alive.remove(sid)
            self._sizes.pop(sid, None)
            if not self.alive:
                raise RuntimeError("all replay shards are dead")

    def total_size(self) -> int:
        return sum(self._sizes.values())

    def push(self, clock: int, items: Dict[str, np.ndarray],
             priorities: np.ndarray) -> None:
        """Deal one round's trajectories (leaves (n, ...)) across the
        surviving shards, stratified by priority rank."""
        assign = stratified_assign(priorities, len(self.alive))
        for j, sid in enumerate(list(self.alive)):
            take = assign == j
            if not take.any():
                continue
            sub = {k: v[take] for k, v in items.items()}
            payload = {"clock": clock, "items": encode_entries(sub),
                       "priorities": [float(x) for x in priorities[take]]}
            try:
                reply = self.transport.role_call(sid, "replay_push", payload)
            except RoleHostDied:
                self.drop(sid)
                continue
            self._sizes[sid] = int(reply["size"])

    def sample(self, batch: int, seed: int
               ) -> Tuple[List[Tuple[int, List[int]]],
                          Dict[str, np.ndarray], np.ndarray]:
        """Draw `batch` trajectories split evenly over surviving shards
        (shard-id order; remainders to the lowest ids).  Returns
        (refs, items, weights): `refs` maps each drawn slice back to
        its (shard, slot indices) for `update`."""
        shards = list(self.alive)
        k = len(shards)
        counts = [batch // k + (1 if i < batch % k else 0)
                  for i in range(k)]
        refs: List[Tuple[int, List[int]]] = []
        parts: List[Dict[str, np.ndarray]] = []
        weights: List[np.ndarray] = []
        for sid, n in zip(shards, counts):
            if n == 0:
                continue
            try:
                reply = self.transport.role_call(
                    sid, "replay_sample", {"batch": n, "seed": int(seed)})
            except RoleHostDied:
                self.drop(sid)
                continue
            got = decode_entries(reply["entries"])
            weights.append(got.pop("__weights__"))
            parts.append(got)
            refs.append((sid, reply["idx"]))
        if not parts:
            raise RuntimeError("replay sample returned no items "
                               "(all polled shards died mid-call)")
        items = {key: np.concatenate([p[key] for p in parts])
                 for key in parts[0]}
        return refs, items, np.concatenate(weights)

    def update(self, refs: List[Tuple[int, List[int]]],
               priorities: np.ndarray) -> None:
        """Write fresh priorities back to the shards each slice of a
        sample came from (dead shards are silently dropped)."""
        off = 0
        for sid, idx in refs:
            pr = priorities[off:off + len(idx)]
            off += len(idx)
            if sid not in self.alive:
                continue
            try:
                self.transport.role_call(
                    sid, "replay_update",
                    {"idx": list(idx), "priorities": [float(x) for x in pr]})
            except RoleHostDied:
                self.drop(sid)


class Actor:
    """One rollout worker: owns its env stream and a stale parameter
    replica pulled from the learner role every `pull_every` acts.
    Compute runs in the launching process on `device` (proc-transport
    actor hosts are heartbeat shells, like the elastic training
    workers); elasticity is the point — an actor's death loses only its
    future rollouts."""

    def __init__(self, wid: int, env: ChainEnv, transport, learner_host:
                 int, template: Pytree, *, pull_every: int = 4,
                 gamma: float = 0.97, device: DeviceLike = None):
        self.wid = wid
        self.env = env
        self.transport = transport
        self.learner_host = learner_host
        self.template = template
        self.pull_every = pull_every
        self.gamma = gamma
        self.device = resolve_device(device)
        self.env_state = env.reset((), self.device)
        self.params: Optional[Pytree] = None
        self.version = 0          # learner version of the held params
        self.acts = 0
        self.credit = 0.0         # fractional rate credit (async pacing)

    def pull(self) -> None:
        reply = self.transport.role_call(self.learner_host, "learner_pull")
        entries = decode_entries(reply["entries"])
        self.params = _unflatten_like(
            self.template, {k: torch.from_numpy(v).to(self.device)
                            for k, v in entries.items()})
        self.version = int(reply["version"])

    def act(self, noise, rollout_len: int
            ) -> Tuple[Dict[str, np.ndarray], float]:
        """One rollout from the Gumbel draws `noise` (rollout_len, A);
        returns (trajectory leaves (1, ...) ready for
        `ReplayService.push`, initial priority).  Pulls fresh params on
        the first act and every `pull_every` thereafter."""
        if self.params is None or self.acts % self.pull_every == 0:
            self.pull()
        self.acts += 1
        if not isinstance(noise, torch.Tensor):
            noise = torch.tensor(np.asarray(noise))
        nstate, traj, boot_obs, prio = _act(
            self.params, self.env_state, noise.to(self.device),
            env=self.env, rollout_len=rollout_len, gamma=self.gamma)
        self.env_state = nstate
        # int leaves (action) ride the float32 codec exactly: chain
        # actions are tiny ints, cast back in the learner
        items = {k: traj[k].float().cpu().numpy()[None]
                 for k in ("obs", "action", "logits", "reward", "done")}
        items["boot_obs"] = boot_obs.cpu().numpy()[None]
        return items, float(prio)


class Learner:
    """The central V-trace learner: owns the canonical parameters and
    optimizer step, samples from the replay service, and publishes each
    update to the "learner" role so actors can pull it.  The publish
    version is the fleet's staleness unit."""

    def __init__(self, transport, host: int, params: Pytree, *,
                 lr: float = 0.05, gamma: float = 0.97,
                 entropy_coef: float = 0.01, value_coef: float = 0.5):
        self.transport = transport
        self.host = host
        self.params = params
        self.device = next(iter(_flatten(params).values())).device
        self.lr = lr
        self.gamma = gamma
        self.entropy_coef = entropy_coef
        self.value_coef = value_coef
        self.steps = 0
        transport.role_open(host, "learner",
                            entries=encode_entries(_to_entries(params)))
        self.version = 1          # the seed publish above

    def step(self, service: ReplayService, batch: int) -> float:
        """Sample -> V-trace update -> publish -> write back fresh
        priorities; returns the scalar loss."""
        refs, items, w = service.sample(batch, seed=self.steps)
        w = w / w.max()           # re-normalize across shards
        tbatch = {k: torch.from_numpy(v).to(self.device)
                  for k, v in items.items()}
        self.params, loss, prios = _learn(
            self.params, tbatch, torch.from_numpy(w).to(self.device),
            gamma=self.gamma, lr=self.lr, entropy_coef=self.entropy_coef,
            value_coef=self.value_coef)
        reply = self.transport.role_call(
            self.host, "learner_publish",
            {"entries": encode_entries(_to_entries(self.params))})
        self.version = int(reply["version"])
        service.update(refs, prios.cpu().numpy().astype(np.float64))
        self.steps += 1
        return float(loss)


# ---------------------------------------------------------------------------
# the fleet loop
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FleetResult:
    losses: List[float]           # learner loss per learner step
    env_steps: int                # env transitions collected by actors
    sim_time: float               # simulated time units (1.0 per round)
    learner_steps: int
    final_version: int            # published param version at the end
    staleness_max: int            # worst (published - held) at act time
    staleness_sum: int
    staleness_samples: int
    transitions: List[Tuple]      # membership transition log
    final_actors: Tuple[int, ...]
    final_shards: Tuple[int, ...]
    final_params: Pytree
    final_return: float           # greedy episode return of final params

    @property
    def goodput(self) -> float:
        return self.env_steps / max(self.sim_time, 1e-9)

    @property
    def staleness_mean(self) -> float:
        return self.staleness_sum / max(self.staleness_samples, 1)


def _merge_host_events(rec, transport) -> None:
    """Best-effort pull of surviving workers' flight rings (proc only);
    post-mortem sugar must never fail a run."""
    pull = getattr(transport, "host_events", None)
    if pull is None:
        return
    try:
        rec.merge(pull())
    except Exception as e:          # noqa: BLE001
        log.warning("[obs] host event pull failed: %s", e)


def run_fleet(*, actors: int = 4, replay_shards: int = 2, steps: int = 40,
              rollout_len: int = 16, batch: int = 16, pull_every: int = 4,
              capacity: int = 1024, alpha: float = 0.6, beta: float = 0.4,
              lr: float = 0.05, gamma: float = 0.97,
              entropy_coef: float = 0.01, value_coef: float = 0.5,
              hidden: int = 32, env: Optional[ChainEnv] = None,
              trace: Optional[FailureTrace] = None, transport=None,
              seed: int = 0, heartbeat_timeout: int = 3,
              evaluate: bool = True, noise: Optional[NoiseFn] = None,
              device: DeviceLike = None) -> FleetResult:
    """Run the actor–learner fleet for `steps` wall rounds on `device`.

    Membership layout: actor ids 0..actors-1, replay ids
    actors..actors+replay_shards-1, learner id actors+replay_shards.
    `trace` events address those ids; pass `transport` to run the same
    trace against real processes (ProcTransport(inject=trace)) — the
    learner's loss trajectory is the same float for float either way.
    The initial weights are `ac_init`'s from a CPU generator seeded
    `seed`, moved to `device`.  `noise(wid, n)`: the Gumbel draws
    (rollout_len, A) of actor wid's n-th rollout (default
    `actor_draws`)."""
    dev = resolve_device(device)
    env = env or ChainEnv()
    num_hosts = actors + replay_shards + 1
    shard_ids = list(range(actors, actors + replay_shards))
    learner_id = actors + replay_shards
    noise = noise or (lambda wid, n: actor_draws(
        seed, wid, n, rollout_len, env.num_actions))
    transport = transport or SimTransport(trace or FailureTrace())
    coord = Coordinator(transport, num_workers=num_hosts,
                        heartbeat_timeout=heartbeat_timeout)

    sim_time = 0.0
    orec = obs.get()
    if orec.enabled:
        # spans land on the simulated clock: a replayed trace emits a
        # byte-deterministic timeline (same convention as run_elastic)
        orec.clock = lambda: sim_time

    # ---- bring up the roles (unwind the transport on setup failure,
    # the main loop's finally is not armed yet) ------------------------
    try:
        params = ac_init(torch.Generator().manual_seed(seed), env.obs_dim,
                         env.num_actions, hidden=hidden)
        params0 = _unflatten_like(params, {
            k: v.to(dev) for k, v in _flatten(params).items()})
        learner = Learner(transport, learner_id, params0, lr=lr,
                          gamma=gamma, entropy_coef=entropy_coef,
                          value_coef=value_coef)
        service = ReplayService(transport, shard_ids, capacity=capacity,
                                alpha=alpha, beta=beta, seed=seed)

        def new_actor(w):
            return Actor(w, env, transport, learner_id, params0,
                         pull_every=pull_every, gamma=gamma, device=dev)
        fleet: Dict[int, Actor] = {w: new_actor(w) for w in range(actors)}
    except BaseException:
        coord.close()
        raise

    losses: List[float] = []
    env_steps = 0
    stale_max = stale_sum = stale_n = 0

    try:
        for wall in range(steps):
            for t in coord.advance(wall):
                if t.kind == "death":
                    if t.worker in fleet:
                        del fleet[t.worker]     # lost throughput only
                        if not fleet:
                            raise RuntimeError(
                                f"wall step {wall}: all actors dead")
                    elif t.worker in service.alive:
                        service.drop(t.worker)  # degrade to survivors
                    elif t.worker == learner_id:
                        raise RuntimeError(
                            f"wall step {wall}: learner host "
                            f"{learner_id} died — it holds the "
                            f"canonical parameters")
                elif t.kind == "join":
                    fleet[t.worker] = new_actor(t.worker)

            rates = coord.rates()
            round_items: List[Dict[str, np.ndarray]] = []
            round_prios: List[float] = []
            for wid in sorted(fleet):
                actor = fleet[wid]
                actor.credit = min(actor.credit + rates.get(wid, 1.0), 1.0)
                if actor.credit < 1.0:
                    continue        # a slow actor acts in fewer rounds
                actor.credit -= 1.0
                draws = noise(wid, actor.acts)
                with orec.span("actor.rollout", host=wid, cat="rl",
                               wall=wall):
                    items, prio = actor.act(draws, rollout_len)
                stale = learner.version - actor.version
                stale_max = max(stale_max, stale)
                stale_sum += stale
                stale_n += 1
                if orec.enabled:
                    orec.gauge("rl.staleness", float(stale))
                round_items.append(items)
                round_prios.append(prio)
                env_steps += rollout_len
            if round_items:
                stacked = {k: np.concatenate([it[k] for it in round_items])
                           for k in round_items[0]}
                service.push(wall, stacked,
                             np.asarray(round_prios, np.float64))
            if service.total_size() >= batch:
                with orec.span("learner.step", host=f"learner{learner_id}",
                               cat="rl", wall=wall, step=learner.steps):
                    losses.append(learner.step(service, batch))
            sim_time += 1.0

        if orec.enabled:
            orec.gauge("rl.env_steps", float(env_steps))
            orec.gauge("rl.sim_time", sim_time)
            orec.gauge("rl.goodput", env_steps / max(sim_time, 1e-9))
            orec.gauge("rl.learner_steps", float(learner.steps))
            _merge_host_events(orec, transport)
        final_return = float(episode_return(
            env, learner.params, policy_logits)) if evaluate \
            else float("nan")
    finally:
        coord.close()   # tears down ProcTransport children; sim: no-op

    return FleetResult(
        losses=losses, env_steps=env_steps, sim_time=sim_time,
        learner_steps=learner.steps, final_version=learner.version,
        staleness_max=stale_max, staleness_sum=stale_sum,
        staleness_samples=stale_n,
        transitions=coord.transition_log(),
        final_actors=tuple(sorted(fleet)),
        final_shards=tuple(service.alive),
        final_params=learner.params, final_return=final_return)
