"""Pipeline parallelism (survey §Pipelining parallelism, GPipe-style).

The PyTorch counterpart of the JAX package's ``core/pipeline.py``.
Stages are a dim of a ``DeviceMesh``, one rank a stage; activations move
to the next stage with ``torch.distributed`` point-to-point sends, the
counterpart of ``ppermute``.  The schedule is synchronous microbatching
(GPipe): M microbatches flow through S stages in M+S-1 ticks, bubble
fraction (S-1)/(M+S-1).

Differentiable end to end, as JAX's is: the move to the next stage is an
autograd function whose backward sends the gradient back, the last
stage's outputs reach every stage by a broadcast whose backward keeps
the last stage's gradient, and the entry hands every stage the whole
gradient of the stacked parameters and of the input (summed over the
stages, each of which holds its own layers' part).  A token threaded
through every move orders the backward's sends the same way on every
rank.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def sequential_apply(block_fn: Callable, stacked_params: Any,
                     x: torch.Tensor) -> torch.Tensor:
    """Reference: block_fn over the whole stack, layer by layer."""
    L = tree_leaves(stacked_params)[0].shape[0]
    h = x
    for i in range(L):
        h = block_fn(tree_map(lambda p: p[i], stacked_params), h)
    return h


class _Stage:
    """This rank's place in the stage group."""

    def __init__(self, mesh, axis: str):
        import torch.distributed as dist
        self.S = mesh.size(mesh.mesh_dim_names.index(axis))
        self.idx = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)
        self.nxt = dist.get_global_rank(self.group, (self.idx + 1) % self.S)
        self.prv = dist.get_global_rank(self.group, (self.idx - 1) % self.S)
        self.last = dist.get_global_rank(self.group, self.S - 1)


def _shift(t: torch.Tensor, send_to: int, recv_from: int,
           stage: _Stage) -> torch.Tensor:
    """Send t to `send_to`, receive a tensor like it from `recv_from`."""
    import torch.distributed as dist
    if stage.S == 1:
        return t.clone()
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t.contiguous(), send_to, stage.group),
        dist.P2POp(dist.irecv, out, recv_from, stage.group)])
    for r in reqs:
        r.wait()
    return out


class _Entry(torch.autograd.Function):
    """Identity on (token seed, x, leaves...); the backward sums the
    gradients of x and of the stacked leaves over the stages."""

    @staticmethod
    def forward(ctx, stage, x, *leaves):
        ctx.stage = stage
        token = x.new_zeros(())
        return (token, x.clone()) + tuple(p.clone() for p in leaves)

    @staticmethod
    def backward(ctx, gtoken, gx, *gleaves):
        import torch.distributed as dist
        stage = ctx.stage
        out = []
        for g in (gx,) + gleaves:
            g = g.contiguous()
            if stage.S > 1:
                dist.all_reduce(g, group=stage.group)
            out.append(g)
        return (None,) + tuple(out)


class _Permute(torch.autograd.Function):
    """The counterpart of ppermute to the next stage: (token, out) ->
    (token, what the previous stage sent).  The backward sends the
    gradient back to the previous stage and receives this stage's from
    the next."""

    @staticmethod
    def forward(ctx, stage, token, out):
        ctx.stage = stage
        return token.clone(), _shift(out, stage.nxt, stage.prv, stage)

    @staticmethod
    def backward(ctx, gtoken, grecv):
        stage = ctx.stage
        return None, gtoken, _shift(grecv, stage.prv, stage.nxt, stage)


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs on every stage (the masked psum); the
    backward keeps the gradient on the last stage only, since every
    stage's loss reads the same outputs."""

    @staticmethod
    def forward(ctx, stage, token, outputs):
        import torch.distributed as dist
        ctx.stage = stage
        outputs = outputs.contiguous().clone()
        if stage.S > 1:
            dist.broadcast(outputs, src=stage.last, group=stage.group)
        return outputs

    @staticmethod
    def backward(ctx, g):
        stage = ctx.stage
        keep = stage.idx == stage.S - 1
        return None, g.new_zeros(()), (g if keep else torch.zeros_like(g))


def pipeline_apply(block_fn: Callable, stacked_params: Any, x: torch.Tensor,
                   mesh, *, axis: str = "stage",
                   num_microbatches: int = 8) -> torch.Tensor:
    """Run `block_fn` stacks over `x` with GPipe pipelining.

    block_fn(layer_params, h) -> h, applied over a stack of L layers.
    stacked_params: tree with leading layer dim L (L % stages == 0), the
    whole stack on every rank; stage r runs layers [r*L/S, (r+1)*L/S).
    x: (B, ...) with B % num_microbatches == 0, the same on every rank
    (only stage 0 reads it).  `mesh` has a dim `axis` of S ranks, and
    every rank of it calls this.

    Returns the block-stack output on every rank, what the sequential
    application gives (`sequential_apply`)."""
    stage = _Stage(mesh, axis)
    S, M = stage.S, num_microbatches
    B = x.shape[0]
    assert B % M == 0, (B, M)
    mb = B // M
    leaves = tree_leaves(stacked_params)
    L = leaves[0].shape[0]
    assert L % S == 0, f"layers {L} not divisible by stages {S}"
    per = L // S

    token, x, *leaves = _Entry.apply(stage, x, *leaves)
    it = iter(leaves)
    params = tree_map(lambda _: next(it), stacked_params)
    lo = stage.idx * per
    local = [tree_map(lambda p: p[lo + i], params) for i in range(per)]
    xs = x.reshape((M, mb) + tuple(x.shape[1:]))

    def local_stack(h):
        for lp in local:
            h = block_fn(lp, h)
        return h

    state = xs.new_zeros(xs.shape[1:])
    outputs = [xs.new_zeros(xs.shape[1:])] * M
    for t in range(M + S - 1):
        # stage 0 takes microbatch t (zeros after the last), the others
        # what the previous stage sent
        if stage.idx == 0:
            inp = xs[t] if t < M else torch.zeros_like(xs[0])
        else:
            inp = state
        out = local_stack(inp)
        done = t - (S - 1)
        if stage.idx == S - 1 and done >= 0:
            outputs[done] = out
        token, state = _Permute.apply(stage, token, out)
    y = _Broadcast.apply(stage, token, torch.stack(outputs))
    return y.reshape((B,) + tuple(x.shape[1:]))
