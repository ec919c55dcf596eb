"""Distributed boosting (survey §Distributed classification, refs 40-44).

The port of the JAX package's ``classic/boosting.py``.  Weak learner:
decision stumps (feature, threshold, polarity); the stump search is a
(features × thresholds × polarity) argmin over weighted error.

Two distributed AdaBoost variants after Cooper & Reyzin (ref 44):

* ``dist_full``  — every round the weighted error of EVERY candidate stump
  is computed on every site and all-reduced, so the chosen stump is exactly
  the centralized one (high communication: candidate-grid statistics each
  round).
* ``dist_sample`` — each site trains a stump on its local shard only and
  broadcasts (stump, local weighted error); the coordinator picks the best
  site's stump (little communication: W stumps/round).

Both return per-round ``comm_floats``.  Labels are ±1.  The (n, d, t, 2)
candidate predictions are built a slice of rows at a time, at most
CHUNK_ELEMS elements each; ties in the stump search go to the first
minimum, as in JAX.  Every tensor lives on the device of the data.
"""
from __future__ import annotations

import dataclasses

import torch

# elements of one (rows, d, t, 2) slice of candidate predictions
CHUNK_ELEMS = 1 << 28


def quantile(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=0)`` with its linear interpolation, by a
    sort: (n, ...) -> (len(q), ...).  ``torch.quantile`` refuses a
    reduced axis longer than 2^24 elements."""
    s = torch.sort(x, 0)[0]
    n = torch.tensor(x.shape[0], dtype=s.dtype, device=s.device)
    pos = q.to(s.dtype) * (n - 1)     # n in the data's float, as in JAX
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    low = torch.minimum(torch.clamp(low, min=0), n - 1).long()
    high = torch.minimum(torch.clamp(high, min=0), n - 1).long()
    shape = (-1,) + (1,) * (x.dim() - 1)
    # low * lw + (high * hw) with one rounding of the sum, as XLA fuses it
    # into a multiply-add: a float64 product of two fp32 values is exact
    high_term = (s[high] * hw.reshape(shape)).double()
    return (s[low].double() * lw.reshape(shape).double()
            + high_term).to(s.dtype)


def linspace(start: float, stop: float, num: int, device=None):
    """float32 ``jnp.linspace``: start * (1 - s) + stop * s with
    s = i / (num - 1) for i < num - 1, then ``stop`` itself."""
    div = num - 1
    s = torch.arange(div, dtype=torch.float32) / torch.tensor(
        float(div), dtype=torch.float32)
    out = start * (1 - s) + stop * s
    return torch.cat([out, torch.tensor([stop])]).to(device)


@dataclasses.dataclass(frozen=True)
class StumpGrid:
    """Candidate stumps: thresholds per feature (shared across sites)."""
    thresholds: torch.Tensor  # (d, t)

    @staticmethod
    def from_data(x: torch.Tensor, num_thresholds: int = 16) -> "StumpGrid":
        qs = linspace(0.0, 1.0, num_thresholds + 2, x.device)[1:-1]
        return StumpGrid(quantile(x, qs).T.contiguous())  # (d, t)


def _stump_preds(x, grid: StumpGrid):
    """(n,d) -> predictions (n, d, t, 2) in {-1,+1} for both polarities."""
    raw = torch.where(x[:, :, None] > grid.thresholds[None], 1.0, -1.0)
    return torch.stack([raw, -raw], -1)


def _weighted_errors(x, y, w, grid: StumpGrid):
    """(d, t, 2) weighted error of every candidate stump on (x, y, w)."""
    n = x.shape[0]
    rows = max(1, CHUNK_ELEMS // (2 * grid.thresholds.numel()))
    errors = None
    for s in range(0, n, rows):
        e = min(s + rows, n)
        wrong = (_stump_preds(x[s:e], grid)
                 != y[s:e, None, None, None]).to(x.dtype)
        part = torch.einsum("n,ndtp->dtp", w[s:e], wrong)
        errors = part if errors is None else errors + part
    return errors


def _pick(errors):
    """The first minimum of the (d, t, 2) grid, as (d, t, p, error)."""
    flat = torch.argmin(errors.reshape(-1))
    t2 = errors.shape[1] * errors.shape[2]
    return (flat // t2, (flat % t2) // errors.shape[2],
            flat % errors.shape[2], errors.reshape(-1)[flat])


def _apply_stump(x, grid: StumpGrid, d, t, p):
    thr = grid.thresholds[d, t]
    raw = torch.where(x[..., d] > thr, 1.0, -1.0)
    return torch.where(p == 0, raw, -raw)


def _alpha(err):
    e = torch.clamp(err, 1e-9, 1 - 1e-9)
    return 0.5 * torch.log((1 - e) / e)


def _model(picks, grid, **extra):
    d, t, p, a = (torch.stack(v) for v in zip(*picks))
    return {"d": d, "t": t, "p": p, "alpha": a, "grid": grid, **extra}


def adaboost_centralized(x, y, rounds: int, grid: StumpGrid = None):
    """Reference AdaBoost (Freund & Schapire, ref 39) with stumps."""
    if grid is None:
        grid = StumpGrid.from_data(x)
    n = x.shape[0]
    w = torch.full((n,), 1.0 / n, device=x.device)
    picks = []
    for _ in range(rounds):
        d, t, p, err = _pick(_weighted_errors(x, y, w, grid))
        a = _alpha(err)
        w = w * torch.exp(-a * y * _apply_stump(x, grid, d, t, p))
        w = w / torch.sum(w)
        picks.append((d, t, p, a))
    return _model(picks, grid)


def adaboost_dist_full(x_w, y_w, rounds: int, grid: StumpGrid = None):
    """Cooper alg 1: exact distributed AdaBoost — per-round all-reduce of the
    full candidate-error grid.  x_w: (W, n, d); y_w: (W, n) in ±1."""
    W, n, dim = x_w.shape
    if grid is None:
        grid = StumpGrid.from_data(x_w.reshape(-1, dim))
    w_w = torch.full((W, n), 1.0 / (W * n), device=x_w.device)
    picks = []
    for _ in range(rounds):
        # all-reduce: the communication step
        errors = torch.stack([_weighted_errors(x, y, w, grid) for x, y, w
                              in zip(x_w, y_w, w_w)]).sum(0)
        d, t, p, err = _pick(errors)
        a = _alpha(err)
        w_w = w_w * torch.exp(-a * y_w * _apply_stump(x_w, grid, d, t, p))
        w_w = w_w / torch.sum(w_w)  # global renormalize (scalar all-reduce)
        picks.append((d, t, p, a))
    comm_floats = rounds * W * (grid.thresholds.numel() * 2 + 1)
    return _model(picks, grid, comm_floats=comm_floats)


def adaboost_dist_sample(x_w, y_w, rounds: int, grid: StumpGrid = None):
    """Cooper alg 2: each site trains locally; only (stump, error) travels.

    The coordinator keeps the globally-best site's stump each round; weights
    update everywhere with the broadcast stump."""
    W, n, dim = x_w.shape
    if grid is None:
        grid = StumpGrid.from_data(x_w.reshape(-1, dim))
    w_w = torch.full((W, n), 1.0 / (W * n), device=x_w.device)
    picks = []
    for _ in range(rounds):
        # each site picks its own best stump on its LOCAL errors
        local = [_pick(_weighted_errors(x, y, w, grid))
                 for x, y, w in zip(x_w, y_w, w_w)]
        # evaluate each site's stump globally (W scalars all-reduced)
        g_errs = torch.stack([
            torch.sum(w_w * (_apply_stump(x_w, grid, d, t, p) != y_w)
                      .to(x_w.dtype)) for d, t, p, _ in local])
        site = int(torch.argmin(g_errs))
        d, t, p, _ = local[site]
        a = _alpha(g_errs[site])
        w_w = w_w * torch.exp(-a * y_w * _apply_stump(x_w, grid, d, t, p))
        w_w = w_w / torch.sum(w_w)
        picks.append((d, t, p, a))
    comm_floats = rounds * W * 4  # (d, t, p, err) per site per round
    return _model(picks, grid, comm_floats=comm_floats)


def predict(model, x) -> torch.Tensor:
    """Signed score of the boosted ensemble."""
    grid = model["grid"]
    scores = [a * _apply_stump(x, grid, d, t, p) for d, t, p, a in
              zip(model["d"], model["t"], model["p"], model["alpha"])]
    return torch.stack(scores).sum(0)


def error_rate(model, x, y) -> torch.Tensor:
    return torch.mean((torch.sign(predict(model, x)) != y).float())
