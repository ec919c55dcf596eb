"""Distributed DRL architectures from the survey, one round a call.

The port of the JAX package's ``rl/agents.py``.  The workers (actors)
are a batch axis, as there: every round rolls all of them out at once
and learns from their joint data (asynchrony -> bounded staleness).

* GORILA (ref 98): N parallel actors fill a shared replay; the learner
  Q-learns from replay with a periodically-synced target network.
* A3C (ref 100): W actor-learners' advantage actor-critic gradients are
  applied as one merged (summed) gradient per round.
* IMPALA (ref 101): actors roll out with STALE policy parameters; the
  central learner applies V-trace-corrected updates.
* DPPO (ref 102): PPO clipped-surrogate gradients averaged over workers.
* Ape-X (ref 104): GORILA's actors + prioritized replay from replay.py.

JAX vmaps a per-worker ``value_and_grad`` and sums or averages the
gradients; here the gradient of the summed or averaged loss is taken,
which is the same function.  Networks are lists of ``{"w", "b"}``
layers.  Randomness is explicit: a round takes ``noise``, a
``torch.Generator`` or the draws themselves (the Gumbel draws of the
rollouts, shaped (workers, rollout_len, num_actions), and for GORILA
also the replay's uniforms).  Every tensor lives on the device of the
inputs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.rl import replay as RP
from repro_torch.rl.env import ChainEnv, batched_rollout, gumbel
from repro_torch.rl.vtrace import nstep_returns, vtrace

Pytree = Any
Noise = Union[Pytree, torch.Generator]


# ---------------------------------------------------------------------------
# trees of dicts and lists
# ---------------------------------------------------------------------------
def tree_map(fn: Callable, tree, *rest):
    """Map over the leaves of nested dicts, lists and (named) tuples (dict
    keys sorted, JAX's leaf order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    out = []
    tree_map(out.append, tree)
    return out


def value_and_grad(loss_fn: Callable, params: Pytree, has_aux=False):
    """(loss, grads) of loss_fn at params, or ((loss, aux), grads);
    the grads mirror params, params are untouched."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    out = loss_fn(leaves)
    loss = out[0] if has_aux else out
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    g = tree_map(lambda _: next(grads), params)
    if has_aux:
        return (loss.detach(), out[1]), g
    return loss.detach(), g


# ---------------------------------------------------------------------------
# tiny MLP nets
# ---------------------------------------------------------------------------
def mlp_init(generator: torch.Generator, sizes) -> Pytree:
    """He-normal weights drawn from ``generator``, on its device."""
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=generator,
                        device=generator.device) * (2.0 / a) ** 0.5
        params.append({"w": w, "b": torch.zeros(b, device=generator.device)})
    return params


def mlp_apply(params, x) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def ac_init(generator: torch.Generator, obs_dim, num_actions, hidden=64):
    return {"pi": mlp_init(generator, (obs_dim, hidden, num_actions)),
            "v": mlp_init(generator, (obs_dim, hidden, 1))}


def policy_logits(params, obs):
    return mlp_apply(params["pi"], obs)


def value(params, obs):
    return mlp_apply(params["v"], obs)[..., 0]


def _sgd(params, grads, lr):
    return tree_map(lambda p, g: p - lr * g, params, grads)


def _rollout_draws(noise: Noise, workers: int, rollout_len: int,
                   env: ChainEnv, device) -> torch.Tensor:
    if isinstance(noise, torch.Generator):
        return gumbel((workers, rollout_len, env.num_actions), noise, device)
    return noise


def _workers(env_states) -> int:
    return env_states["pos"].shape[0]


def _take(logp, action):
    return torch.gather(logp, -1, action.long()[..., None])[..., 0]


def _entropy(logp):
    return -torch.sum(torch.exp(logp) * logp, -1)


# ---------------------------------------------------------------------------
# GORILA / Ape-X: parallel actors -> (prioritized) replay -> Q learner
# ---------------------------------------------------------------------------
class QLearnerState(NamedTuple):
    params: Pytree
    target: Pytree
    replay: RP.Replay
    env_states: Pytree
    step: int


def q_init(env: ChainEnv, generator: torch.Generator, *, actors: int = 4,
           capacity: int = 4096, hidden: int = 64) -> QLearnerState:
    """Q-net weights from ``generator``; every tensor on its device."""
    dev = generator.device
    params = mlp_init(generator, (env.obs_dim, hidden, env.num_actions))
    f = torch.zeros((), device=dev)
    item = {"obs": torch.zeros(env.obs_dim, device=dev),
            "action": torch.zeros((), dtype=torch.int32, device=dev),
            "reward": f, "done": f,
            "next_obs": torch.zeros(env.obs_dim, device=dev)}
    rep = RP.replay_init(capacity, item)
    return QLearnerState(params, params, rep, env.reset((actors,), dev), 0)


def gorila_round(state: QLearnerState, noise: Noise, *, env: ChainEnv,
                 rollout_len: int = 16, batch: int = 64,
                 gamma: float = 0.97, lr: float = 5e-2, eps: float = 0.2,
                 sync_every: int = 8, prioritized: bool = False
                 ) -> Tuple[QLearnerState, Dict]:
    """One acting+learning round.  prioritized=True -> Ape-X.  ``noise``:
    a generator, or {"gumbel": (actors, rollout_len, A), "uniform":
    (batch,)}, the rollouts' draws and the replay's."""
    actors = _workers(state.env_states)
    dev = state.env_states["pos"].device
    if isinstance(noise, torch.Generator):
        noise = {"gumbel": _rollout_draws(noise, actors, rollout_len, env,
                                          dev),
                 "uniform": torch.rand(batch, generator=noise,
                                       device=noise.device).to(dev)}

    # --- parallel acting (eps-greedy with the actor replica of params) ---
    def eps_greedy_logits(params, obs):
        q = mlp_apply(params, obs)
        greedy = F.one_hot(torch.argmax(q, -1), q.shape[-1]).float()
        probs = (1 - eps) * greedy + eps / q.shape[-1]
        return torch.log(probs + 1e-9)

    with torch.no_grad():
        env_states, traj = batched_rollout(
            env, state.params, eps_greedy_logits, state.env_states,
            noise["gumbel"], rollout_len)
        # next_obs: obs shifted by one within each actor's rollout
        next_obs = torch.cat([traj["obs"][:, 1:],
                              env.obs(env_states)[:, None]], 1)
        flat = {
            "obs": traj["obs"].reshape(-1, env.obs_dim),
            "action": traj["action"].reshape(-1),
            "reward": traj["reward"].reshape(-1),
            "done": traj["done"].reshape(-1),
            "next_obs": next_obs.reshape(-1, env.obs_dim),
        }
        # priorities of fresh data = |TD error| under current params
        q_next = torch.max(mlp_apply(state.params, flat["next_obs"]), -1)[0]
        targets = flat["reward"] + gamma * (1 - flat["done"]) * q_next
        q_cur = _take(mlp_apply(state.params, flat["obs"]), flat["action"])
        rep = RP.replay_add(state.replay, flat, targets - q_cur)

        # --- learner: one Q step from replay ---
        items, idx, is_w = RP.replay_sample(rep, noise["uniform"], batch)
        if not prioritized:
            is_w = torch.ones_like(is_w)
        qn = torch.max(mlp_apply(state.target, items["next_obs"]), -1)[0]
        tgt = items["reward"] + gamma * (1 - items["done"]) * qn

    def loss_fn(params):
        td = tgt - _take(mlp_apply(params, items["obs"]), items["action"])
        return torch.mean(is_w * td ** 2), td.detach()

    (loss, td), grads = value_and_grad(loss_fn, state.params, has_aux=True)
    params = _sgd(state.params, grads, lr)
    if prioritized:
        rep = RP.replay_update_priorities(rep, idx, td)

    step = state.step + 1
    target = params if step % sync_every == 0 else state.target
    new = QLearnerState(params, target, rep, env_states, step)
    return new, {"loss": loss, "mean_td": torch.mean(torch.abs(td))}


def greedy_q_policy(params, obs):
    return mlp_apply(params, obs)  # argmax of logits == argmax of Q


# ---------------------------------------------------------------------------
# A3C: W advantage-actor-critic workers, merged online updates
# ---------------------------------------------------------------------------
def _ac_terms(p, traj, boot_obs, gamma):
    """Per-step terms every actor-critic round shares: V(x_t) (W, T),
    the bootstrap value (W,), discounts and the log-softmax policy."""
    v = value(p, traj["obs"])
    boot = value(p, boot_obs)
    disc = gamma * (1 - traj["done"])
    logp_all = F.log_softmax(policy_logits(p, traj["obs"]), -1)
    return v, boot, disc, logp_all


def a3c_round(params, env_states, noise: Noise, *, env: ChainEnv,
              rollout_len: int = 16, gamma: float = 0.97,
              lr: float = 5e-2, entropy_coef: float = 0.01,
              value_coef: float = 0.5) -> Tuple[Pytree, Pytree, Dict]:
    workers = _workers(env_states)
    with torch.no_grad():
        env_states, traj = batched_rollout(
            env, params, policy_logits, env_states,
            _rollout_draws(noise, workers, rollout_len, env,
                           env_states["pos"].device), rollout_len)
    boot_obs = env.obs(env_states)

    def loss_fn(p):
        v, boot, disc, logp = _ac_terms(p, traj, boot_obs, gamma)
        g = nstep_returns(traj["reward"], disc, boot).detach()
        adv = (g - v).detach()
        pg = -torch.mean(_take(logp, traj["action"]) * adv, -1)
        vl = torch.mean((g - v) ** 2, -1)
        losses = pg + value_coef * vl - entropy_coef * torch.mean(
            _entropy(logp), -1)
        return torch.sum(losses), losses.detach()

    # merged online update (sum of worker gradients ~ Hogwild's net effect)
    (_, losses), grads = value_and_grad(loss_fn, params, has_aux=True)
    params = _sgd(params, grads, lr / workers)
    return params, env_states, {"loss": torch.mean(losses)}


# ---------------------------------------------------------------------------
# IMPALA: stale actors + central V-trace learner
# ---------------------------------------------------------------------------
def impala_round(params, actor_params, env_states, noise: Noise, *,
                 env: ChainEnv, rollout_len: int = 16, gamma: float = 0.97,
                 lr: float = 5e-2, entropy_coef: float = 0.01,
                 value_coef: float = 0.5, use_vtrace: bool = True
                 ) -> Tuple[Pytree, Pytree, Dict]:
    """actor_params is the STALE replica used for acting; the caller decides
    when to refresh it (actor_params <- params), i.e. the staleness."""
    workers = _workers(env_states)
    with torch.no_grad():
        env_states, traj = batched_rollout(
            env, actor_params, policy_logits, env_states,
            _rollout_draws(noise, workers, rollout_len, env,
                           env_states["pos"].device), rollout_len)
    boot_obs = env.obs(env_states)

    def loss_fn(p):
        return torch.mean(impala_losses(
            p, traj, boot_obs, gamma=gamma, entropy_coef=entropy_coef,
            value_coef=value_coef, use_vtrace=use_vtrace)[0])

    loss, grads = value_and_grad(loss_fn, params)
    return _sgd(params, grads, lr), env_states, {"loss": loss}


def impala_losses(p, traj, boot_obs, *, gamma: float, entropy_coef: float,
                  value_coef: float, use_vtrace: bool = True):
    """The learner's per-trajectory losses on trajectories (..., T) of
    behavior logits, and each one's mean |vs - V|, the fresh priority the
    fleet's learner writes back.  Without V-trace: naive on-policy
    targets on off-policy data."""
    b_logp = _take(F.log_softmax(traj["logits"], -1), traj["action"])
    v, boot, disc, t_logp_all = _ac_terms(p, traj, boot_obs, gamma)
    t_logp = _take(t_logp_all, traj["action"])
    if use_vtrace:
        vs, pg_adv = vtrace(b_logp, t_logp.detach(), traj["reward"], disc,
                            v.detach(), boot.detach())
    else:
        vs = nstep_returns(traj["reward"], disc, boot.detach())
        pg_adv = vs - v.detach()
    pg = -torch.mean(t_logp * pg_adv, -1)
    vl = torch.mean((vs - v) ** 2, -1)
    losses = pg + value_coef * vl - entropy_coef * torch.mean(
        _entropy(t_logp_all), -1)
    return losses, torch.mean(torch.abs(vs - v.detach()), -1)


# ---------------------------------------------------------------------------
# DPPO: synchronous distributed PPO
# ---------------------------------------------------------------------------
def dppo_round(params, env_states, noise: Noise, *, env: ChainEnv,
               rollout_len: int = 16, gamma: float = 0.97,
               lr: float = 5e-2, clip: float = 0.2, ppo_epochs: int = 4,
               entropy_coef: float = 0.01, value_coef: float = 0.5
               ) -> Tuple[Pytree, Pytree, Dict]:
    workers = _workers(env_states)
    with torch.no_grad():
        env_states, traj = batched_rollout(
            env, params, policy_logits, env_states,
            _rollout_draws(noise, workers, rollout_len, env,
                           env_states["pos"].device), rollout_len)
        boot_obs = env.obs(env_states)
        # advantages under the data-collection params (frozen)
        v = value(params, traj["obs"])
        returns = nstep_returns(traj["reward"], gamma * (1 - traj["done"]),
                                value(params, boot_obs))
        advs = returns - v
        old_logp = _take(F.log_softmax(traj["logits"], -1), traj["action"])

    def loss_fn(p):
        logp_all = F.log_softmax(policy_logits(p, traj["obs"]), -1)
        ratio = torch.exp(_take(logp_all, traj["action"]) - old_logp)
        surr = torch.minimum(ratio * advs,
                             torch.clamp(ratio, 1 - clip, 1 + clip) * advs)
        vl = torch.mean((returns - value(p, traj["obs"])) ** 2, -1)
        losses = (-torch.mean(surr, -1) + value_coef * vl
                  - entropy_coef * torch.mean(_entropy(logp_all), -1))
        # synchronous gradient averaging (the paper's preferred variant)
        return torch.mean(losses)

    loss = torch.zeros((), device=env_states["pos"].device)
    for _ in range(ppo_epochs):
        loss, grads = value_and_grad(loss_fn, params)
        params = _sgd(params, grads, lr)
    return params, env_states, {"loss": loss}
