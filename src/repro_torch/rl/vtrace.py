"""V-trace off-policy correction (IMPALA, survey ref 101).

The port of the JAX package's ``rl/vtrace.py``.  Given behavior
log-probs mu and target log-probs pi along a trajectory, truncated
importance weights rho/c correct the value targets so a learner can
consume STALE actor data:

  delta_t = rho_t (r_t + gamma_t V(x_{t+1}) - V(x_t))
  vs_t - V(x_t) = delta_t + gamma_t c_t (vs_{t+1} - V(x_{t+1}))
  pg_adv_t = rho_t (r_t + gamma_t vs_{t+1} - V(x_t))

JAX's reverse ``lax.scan`` becomes a reverse loop over T.  Every
argument may carry leading batch dims (..., T), and the bootstrap value
(...), so a learner corrects a whole (B, T) batch in one call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VTraceOut(NamedTuple):
    vs: torch.Tensor       # (..., T) corrected value targets
    pg_adv: torch.Tensor   # (..., T) policy-gradient advantages


def reverse_scan(init: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """carry_t = a_t + b_t * carry_{t+1} from carry_T = init, over the last
    axis; returns every carry_t, shaped like ``a``."""
    carry, out = init, []
    for t in range(a.shape[-1] - 1, -1, -1):
        carry = a[..., t] + b[..., t] * carry
        out.append(carry)
    return torch.stack(out[::-1], -1)


def vtrace(behavior_logp, target_logp, rewards, discounts, values,
           bootstrap_value, *, clip_rho: float = 1.0,
           clip_c: float = 1.0) -> VTraceOut:
    """Args (..., T); discounts = gamma * (1 - done); values = V(x_t);
    bootstrap_value (...) = V(x_T), the value after the last step.  The
    outputs carry no gradient, as JAX's are stop_gradient'ed."""
    log_is = target_logp - behavior_logp
    rho = torch.clamp(torch.exp(log_is), max=clip_rho)
    c = torch.clamp(torch.exp(log_is), max=clip_c)
    boot = bootstrap_value[..., None]
    values_tp1 = torch.cat([values[..., 1:], boot], -1)
    deltas = rho * (rewards + discounts * values_tp1 - values)
    diffs = reverse_scan(torch.zeros_like(bootstrap_value), deltas,
                         discounts * c)
    vs = values + diffs
    vs_tp1 = torch.cat([vs[..., 1:], boot], -1)
    pg_adv = rho * (rewards + discounts * vs_tp1 - values)
    return VTraceOut(vs.detach(), pg_adv.detach())


def nstep_returns(rewards, discounts, bootstrap_value) -> torch.Tensor:
    """On-policy n-step (Monte-Carlo-to-bootstrap) returns."""
    return reverse_scan(bootstrap_value, rewards, discounts)
