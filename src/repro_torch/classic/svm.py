"""Distributed linear SVM (survey §Distributed classification, refs 47-51).

The port of the JAX package's ``classic/svm.py``.  Three trainers over
the same primal hinge-loss objective
``λ/2 ||w||² + mean(max(0, 1 - y(xw+b)))``:

* ``svm_centralized``    — Pegasos-style SGD on pooled data (reference).
* ``svm_dist_gradient``  — data-parallel subgradient descent: per-shard
  subgradients all-reduced each step (MRSMO's MapReduce pattern, ref 49 —
  map = local gradient, reduce = mean).
* ``dpsvm``              — DPSVM (Lu et al., ref 48): sites train local
  SVMs and exchange only their SUPPORT VECTORS around a ring; each site
  retrains on (local shard ∪ received SVs).  Communication is |SV|
  vectors per hop instead of the whole shard, measured in
  ``comm_floats``.

Labels are ±1.  The sites of a ring hop run as one batch over the
leading site axis, as JAX vmaps them.  The two full-batch trainers take
their subgradients in float64 (`_subgrad`), the weights stay fp32.
Every tensor lives on the device of the data.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def hinge_objective(params, x, y, lam: float):
    margin = y * (x @ params["w"] + params["b"])
    return (0.5 * lam * torch.sum(params["w"] ** 2)
            + torch.mean(torch.clamp(1.0 - margin, min=0.0)))


def _subgrad(params, x, y, lam):
    """Hinge subgradient on float64 (..., n, d) data with (..., d)
    weights, the leading axes sites; returned in float64.  In float64 a
    pooled pass and its shards' passes take the same active set and sum
    to the same fp32 step, so the distributed trainer stays equal to the
    centralized one at any size (in fp32, margins an ulp from 1 flip
    between the two reduction orders, and each flip moves w)."""
    w, b = params["w"].double(), params["b"].double()
    margin = y * (torch.einsum("...nd,...d->...n", x, w) + b[..., None])
    active = (margin < 1.0).double()  # subgradient of hinge
    n = x.shape[-2]
    gw = lam * w - torch.einsum("...nd,...n->...d", x, active * y) / n
    gb = -torch.sum(active * y, -1) / n
    return {"w": gw, "b": gb}


def _step(p, g, lr):
    return {k: (p[k].double() - lr * g[k]).to(p[k].dtype) for k in p}


def _zeros(d, device):
    return {"w": torch.zeros(d, device=device),
            "b": torch.zeros((), device=device)}


def svm_centralized(x, y, *, lam: float = 1e-3, steps: int = 300,
                    lr0: float = 1.0):
    p = _zeros(x.shape[1], x.device)
    xd, yd = x.double(), y.double()
    hist = []
    for i in range(steps):
        p = _step(p, _subgrad(p, xd, yd, lam), lr0 / (lam * (i + 10.0)))
        hist.append(hinge_objective(p, x, y, lam))
    return p, torch.stack(hist)


def svm_dist_gradient(x_w, y_w, *, lam: float = 1e-3, steps: int = 300,
                      lr0: float = 1.0):
    """Per-step gradient all-reduce; exactly equals centralized full-batch."""
    W, n, d = x_w.shape
    p = _zeros(d, x_w.device)
    xd, yd = x_w.double(), y_w.double()
    for i in range(steps):
        g_w = _subgrad({"w": p["w"].expand(W, d), "b": p["b"].expand(W)},
                       xd, yd, lam)
        g = {k: torch.mean(v, 0) for k, v in g_w.items()}  # all-reduce
        p = _step(p, g, lr0 / (lam * (i + 10.0)))
    return p, steps * W * (d + 1)


def _local_fit(x, y, mask, lam, steps, lr0):
    """Pegasos on the masked subset (mask 0 rows contribute nothing);
    x (..., n, d), the leading axes are sites."""
    p = {"w": torch.zeros(x.shape[:-2] + x.shape[-1:], device=x.device),
         "b": torch.zeros(x.shape[:-2], device=x.device)}
    n_eff = torch.clamp(torch.sum(mask, -1), min=1.0)
    for i in range(steps):
        margin = y * (torch.einsum("...nd,...d->...n", x, p["w"])
                      + p["b"][..., None])
        active = ((margin < 1.0) & (mask > 0)).to(x.dtype)
        gw = lam * p["w"] - torch.einsum(
            "...nd,...n->...d", x, active * y) / n_eff[..., None]
        gb = -torch.sum(active * y, -1) / n_eff
        lr = lr0 / (lam * (i + 10.0))
        p = {"w": p["w"] - lr * gw, "b": p["b"] - lr * gb}
    return p


def dpsvm(x_w, y_w, *, lam: float = 1e-3, hops: int = None,
          local_steps: int = 200, sv_capacity: int = None,
          lr0: float = 1.0) -> Tuple[Dict, Dict]:
    """DPSVM ring: each hop, every site retrains on (shard ∪ ring buffer of
    received SVs) and forwards its current support vectors to the next site.

    Returns (params of site 0, info with comm_floats and sv counts)."""
    W, n, d = x_w.shape
    dev = x_w.device
    hops = hops if hops is not None else W
    cap = sv_capacity if sv_capacity is not None else n

    # fixed-capacity SV buffers per site: (x, y, mask)
    buf_x = torch.zeros((W, cap, d), device=dev)
    buf_y = torch.ones((W, cap), device=dev)
    buf_m = torch.zeros((W, cap), device=dev)
    total_sv = 0.0
    ones = torch.ones((W, n), device=dev)
    rows = torch.arange(W, device=dev)[:, None]

    params_w = None
    for _ in range(hops):
        xs = torch.cat([x_w, buf_x], 1)
        ys = torch.cat([y_w, buf_y], 1)
        ms = torch.cat([ones, buf_m], 1)
        params_w = _local_fit(xs, ys, ms, lam, local_steps, lr0)
        # support vectors of the LOCAL shard: margin <= 1 + eps
        margin = y_w * (torch.einsum("wnd,wd->wn", x_w, params_w["w"])
                        + params_w["b"][:, None])
        is_sv = (margin <= 1.0 + 1e-3).to(x_w.dtype)
        # top-cap by smallest margin (SVs first), masked to is_sv;
        # stable, as jnp.argsort is
        sel = torch.argsort(margin, dim=-1, stable=True)[:, :cap]
        nsv = torch.sum(is_sv, -1)
        # ring: site i receives site (i-1)'s SVs
        buf_x = torch.roll(x_w[rows, sel], 1, 0)
        buf_y = torch.roll(y_w[rows, sel], 1, 0)
        buf_m = torch.roll(is_sv[rows, sel], 1, 0)
        total_sv = total_sv + float(torch.sum(torch.clamp(nsv, max=cap)))

    info = {"comm_floats": total_sv * (d + 1),
            "full_exchange_floats": hops * W * n * (d + 1)}
    return {k: v[0] for k, v in params_w.items()}, info


def accuracy(params, x, y) -> torch.Tensor:
    return torch.mean((torch.sign(x @ params["w"] + params["b"]) == y)
                      .float())
