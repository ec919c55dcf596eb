"""Vectorized environments for the distributed-RL substrate.

The port of the JAX package's ``rl/env.py``.  ``chain``: an N-state
corridor.  The agent starts at the left, must walk right; reward 1 at
the goal, a small step penalty, and the episode ends at the goal or
after ``horizon`` steps.

A state is a dict of int32 tensors of any batch shape, so one call steps
a whole fleet of actors (JAX vmaps a scalar env instead):
  reset(batch, device) -> state
  step(state, action) -> (state, timestep)
with ``timestep = {obs, reward, done}``; auto-reset on done.  JAX's
reset and step take a key the chain never reads, so these take none.

Sampling is explicit: a rollout takes ``noise``, either a
``torch.Generator`` or the Gumbel draws themselves, shaped
(*batch, length, num_actions).  The action is ``argmax(logits + g)``,
which is how ``jax.random.categorical`` samples, so a caller that feeds
JAX's draws gets JAX's actions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch
import torch.nn.functional as F

Noise = Union[torch.Tensor, torch.Generator]


@dataclasses.dataclass(frozen=True)
class ChainEnv:
    length: int = 8
    horizon: int = 24
    step_penalty: float = 0.01

    @property
    def num_actions(self) -> int:
        return 2  # left / right

    @property
    def obs_dim(self) -> int:
        return self.length

    def reset(self, batch: Tuple[int, ...] = (),
              device=None) -> Dict[str, torch.Tensor]:
        z = torch.zeros(batch, dtype=torch.int32, device=device)
        return {"pos": z, "t": z.clone()}

    def obs(self, state) -> torch.Tensor:
        return F.one_hot(state["pos"].long(), self.length).float()

    def step(self, state, action) -> Tuple[Dict, Dict]:
        """action: 0 = left, 1 = right."""
        pos = torch.clamp(state["pos"] + torch.where(action == 1, 1, -1),
                          0, self.length - 1).int()
        t = state["t"] + 1
        at_goal = pos == self.length - 1
        done = at_goal | (t >= self.horizon)
        reward = torch.where(at_goal, 1.0, -self.step_penalty)
        zero = torch.zeros_like(pos)        # the auto-reset state
        nstate = {"pos": torch.where(done, zero, pos),
                  "t": torch.where(done, zero, t)}
        ts = {"obs": self.obs(nstate), "reward": reward,
              "done": done.float()}
        return nstate, ts


def gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """float32 Gumbel draws from ``generator`` (on its device), moved to
    ``device``: -log(-log(u)) with u uniform in [tiny, 1), as
    ``jax.random.gumbel`` draws them."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def rollout(env: ChainEnv, params, policy_fn: Callable, state, noise: Noise,
            length: int) -> Tuple[Dict, Dict[str, Any]]:
    """Unroll `length` steps with policy_fn(params, obs) -> logits from
    `state` (batch shape B).  ``noise``: Gumbel draws (*B, length, A), or
    a generator that draws them.

    Returns (final_state, traj) with traj leaves shaped (*B, length, ...):
    obs (pre-action), action (int32), logits (behavior), reward, done."""
    nb = state["pos"].dim()
    if isinstance(noise, torch.Generator):
        noise = gumbel(tuple(state["pos"].shape) + (length, env.num_actions),
                       noise, state["pos"].device)
    out = {k: [] for k in ("obs", "action", "logits", "reward", "done")}
    for t in range(length):
        obs = env.obs(state)
        logits = policy_fn(params, obs)
        action = torch.argmax(logits + noise[..., t, :], -1).int()
        state, ts = env.step(state, action)
        for k, v in (("obs", obs), ("action", action), ("logits", logits),
                     ("reward", ts["reward"]), ("done", ts["done"])):
            out[k].append(v)
    return state, {k: torch.stack(v, nb) for k, v in out.items()}


def batched_rollout(env: ChainEnv, params, policy_fn: Callable, states,
                    noise: Noise, length: int):
    """Vectorized actors: states have a leading actor axis, the draws
    (actors, length, A)."""
    return rollout(env, params, policy_fn, states, noise, length)


def episode_return(env: ChainEnv, params, policy_fn: Callable,
                   episodes: int = 32) -> torch.Tensor:
    """Mean undiscounted return over `episodes` fresh episodes (greedy),
    on the device of the first leaf of params."""
    dev = _device_of(params)
    state = env.reset((episodes,), dev)
    ret = torch.zeros(episodes, device=dev)
    alive = torch.ones(episodes, device=dev)
    for _ in range(env.horizon):
        action = torch.argmax(policy_fn(params, env.obs(state)), -1).int()
        state, ts = env.step(state, action)
        ret = ret + alive * ts["reward"]
        alive = alive * (1.0 - ts["done"])
    return torch.mean(ret)


def _device_of(tree) -> torch.device:
    """The device of a tree's first leaf (dicts and lists)."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree.device
