"""Distributed k-means (survey §Distributed clustering, refs 57-61).

The port of the JAX package's ``classic/kmeans.py``.  Data is partitioned
across W workers (leading axis).  One Lloyd iteration: each worker
computes local cluster sums/counts over its shard (map), the statistics
are combined by an all-reduce (the sum over the worker axis — the
consensus step of refs 53/58), and all workers apply the identical
centroid refinement.  `consensus_mean` reproduces the iterative
averaging of ref 58.

Also the centralized reference and a fuzzy c-means variant with the
distributed Xie-Beni index (ref 54) for choosing k.

The distances are JAX's elementwise ``sum((x - c)^2)``, not the
``|x|^2 - 2 x.c + |c|^2`` expansion, so argmin ties fall as they do
there.  Its (n, k, d) and (n, k, k) intermediates are built a slice of
rows at a time, at most CHUNK_ELEMS elements each; the Lloyd statistics
accumulate in float64 (`local_stats`).  Every tensor lives on the device
of the data.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

# elements of one (rows, k, d) or (rows, k, k) intermediate: 1 GiB of fp32
CHUNK_ELEMS = 1 << 28


def _chunks(n: int, per_row: int):
    rows = max(1, CHUNK_ELEMS // max(per_row, 1))
    return [(s, min(s + rows, n)) for s in range(0, n, rows)]


def _map_rows(fn: Callable, x: torch.Tensor, per_row: int):
    """fn over slices of x's rows, results concatenated."""
    parts = [fn(x[s:e]) for s, e in _chunks(x.shape[0], per_row)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def _sqdist(x, centroids):
    """(n, k) squared distances, elementwise as JAX computes them."""
    return _map_rows(
        lambda xs: torch.sum((xs[:, None] - centroids[None]) ** 2, -1),
        x, centroids.numel())


def _assign(x, centroids):
    d2 = _sqdist(x, centroids)
    return torch.argmin(d2, -1), d2


def local_stats(x_shard, centroids):
    """Map step on one worker: per-cluster sums and counts, and the
    inertia, accumulated in float64 over slices of rows.  So a pooled
    pass and the sum of its shards' passes round alike, and distributed
    k-means stays equal to centralized at any size (in fp32 the two
    reduction orders part the trajectories once a point's two nearest
    centroids tie to an ulp)."""
    k, d = centroids.shape
    f64 = dict(dtype=torch.float64, device=x_shard.device)
    sums, counts = torch.zeros((k, d), **f64), torch.zeros(k, **f64)
    inertia = torch.zeros((), **f64)
    for s, e in _chunks(x_shard.shape[0], centroids.numel()):
        xs = x_shard[s:e]
        d2 = torch.sum((xs[:, None] - centroids[None]) ** 2, -1)
        oh = torch.nn.functional.one_hot(torch.argmin(d2, -1), k).double()
        sums += oh.T @ xs.double()
        counts += torch.sum(oh, 0)
        inertia += torch.sum(torch.min(d2, -1)[0].double())
    return sums, counts, inertia


def kmeans_step(x_w, centroids) -> Tuple[torch.Tensor, torch.Tensor]:
    """One distributed Lloyd iteration. x_w: (W, n, d)."""
    stats = [local_stats(x, centroids) for x in x_w]
    # consensus/all-reduce over workers
    sums = torch.stack([s[0] for s in stats]).sum(0)
    counts = torch.stack([s[1] for s in stats]).sum(0)
    inertia = torch.stack([s[2] for s in stats]).sum()
    new_c = (sums / torch.clamp(counts[:, None], min=1.0)).to(
        centroids.dtype)
    new_c = torch.where(counts[:, None] > 0, new_c, centroids)
    return new_c, inertia.to(centroids.dtype)


def kmeans_fit(x_w, k: int, iters: int = 20,
               noise: Union[torch.Tensor, torch.Generator, None] = None):
    """``noise``: the k initial row indices into the pooled data, or a
    generator that draws them without replacement (default: a CPU
    generator seeded 0)."""
    W, n, d = x_w.shape
    flat = x_w.reshape(-1, d)
    if noise is None:
        noise = torch.Generator().manual_seed(0)
    if isinstance(noise, torch.Generator):
        noise = torch.randperm(flat.shape[0], generator=noise,
                               device=noise.device)[:k]
    centroids = flat[noise.to(flat.device)]
    history = []
    for _ in range(iters):
        centroids, inertia = kmeans_step(x_w, centroids)
        history.append(inertia)
    return centroids, torch.stack(history)


def kmeans_centralized(x, k: int, iters: int = 20, noise=None):
    """Reference: single-site Lloyd on pooled data."""
    return kmeans_fit(x[None], k, iters, noise)


def consensus_mean(values_w, weights_w, rounds: int,
                   topology: Optional[torch.Tensor] = None):
    """Iterative average-consensus (ref 58): gossip on a ring until the
    weighted mean emerges.  values_w: (W, ...); weights_w: (W,)."""
    W = values_w.shape[0]
    dev = values_w.device
    if topology is None:  # symmetric ring, Metropolis weights
        a = 1.0 / 3.0
        i = torch.arange(W, device=dev)
        mix = torch.zeros((W, W), device=dev)
        # accumulate: on a 2-ring both neighbors are the same node
        for cols, w in ((i, 1 - 2 * a), ((i + 1) % W, a), ((i - 1) % W, a)):
            mix.index_put_((i, cols), torch.full((W,), w, device=dev),
                           accumulate=True)
    else:
        mix = topology
    shape = (W,) + (1,) * (values_w.ndim - 1)
    num = values_w * weights_w.reshape(shape)
    den = weights_w
    for _ in range(rounds):
        num = torch.tensordot(mix, num, dims=1)
        den = mix @ den
    return num / torch.clamp(den.reshape(shape), min=1e-9)


# ---------------------------------------------------------------------------
# Fuzzy c-means + distributed Xie-Beni validity (ref 54)
# ---------------------------------------------------------------------------
def _memberships(x, centroids, m):
    """(n, k) squared distances (+1e-9) and fuzzy memberships u."""
    d2 = _sqdist(x, centroids) + 1e-9
    k = centroids.shape[0]
    u = _map_rows(lambda d: 1.0 / torch.sum(
        (d[:, :, None] / d[:, None, :]) ** (1.0 / (m - 1)), -1), d2, k * k)
    return d2, u


def fuzzy_cmeans_step(x_w, centroids, m: float = 2.0):
    sums, wts, objs = [], [], []
    for x in x_w:
        d2, u = _memberships(x, centroids, m)
        um = u ** m
        sums.append(um.T @ x)
        wts.append(torch.sum(um, 0))
        objs.append(torch.sum(um * d2))
    sums, wts = torch.stack(sums).sum(0), torch.stack(wts).sum(0)
    return sums / torch.clamp(wts[:, None], min=1e-9), torch.stack(objs).sum()


def xie_beni(x_w, centroids, m: float = 2.0) -> torch.Tensor:
    """Distributed Xie-Beni: numerator sums over shards; denominator is a
    pure function of the (shared) centroids."""
    nums = []
    for x in x_w:
        d2, u = _memberships(x, centroids, m)
        nums.append(torch.sum((u ** m) * d2))
    n_total = x_w.shape[0] * x_w.shape[1]
    cd = torch.sum((centroids[:, None] - centroids[None]) ** 2, -1)
    k = centroids.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=centroids.device)
    min_sep = torch.min(torch.where(eye, torch.inf, cd))
    return torch.stack(nums).sum() / (n_total * min_sep)
