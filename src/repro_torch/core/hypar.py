"""HYPAR-style hybrid-parallelism partition search (survey ref 87).

HYPAR picks, PER LAYER, whether tensors are partitioned data-parallel (D)
or model-parallel (M) so that total communication is minimized; the
optimum is a dynamic program over the layer chain with a per-layer comm
cost and a layout-transition cost between adjacent layers.

Costs (bytes, for W-way partitioning of one training step):

  D layer:   gradient all-reduce of the layer's weights  2·|w|·(W-1)/W
  M layer:   activation all-reduce (fwd) + grad all-reduce (bwd)
             2·|act|·(W-1)/W · 2
  D->M / M->D transition: reshard the boundary activation  |act|·(W-1)/W

The DP returns the per-layer assignment; `pure_cost` gives the all-D /
all-M references the survey compares against (HYPAR's claim: the hybrid
beats both on mixed stacks), and `brute_force` the exhaustive optimum the
DP must equal.

A pure-Python copy of the JAX package's ``core/hypar.py``: it imports
neither torch nor jax.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Byte counts for one layer: |weights| and |output activation| per
    global batch (both in elements; dtype width folds into `elem_bytes`)."""
    name: str
    weight_elems: int
    act_elems: int


def _frac(W: int) -> float:
    return (W - 1) / W


def layer_comm(layer: LayerCost, choice: str, W: int,
               elem_bytes: int = 4) -> float:
    if choice == "D":
        return 2.0 * layer.weight_elems * _frac(W) * elem_bytes
    if choice == "M":
        return 4.0 * layer.act_elems * _frac(W) * elem_bytes
    raise ValueError(choice)


def transition_comm(prev: str, cur: str, boundary_act: int, W: int,
                    elem_bytes: int = 4) -> float:
    return 0.0 if prev == cur else boundary_act * _frac(W) * elem_bytes


def hypar_partition(layers: Sequence[LayerCost], W: int,
                    elem_bytes: int = 4) -> Tuple[List[str], float]:
    """DP over the chain; returns (per-layer choices, total comm bytes)."""
    choices = ("D", "M")
    # best[c] = (cost, path) of prefix ending with choice c
    best = {c: (layer_comm(layers[0], c, W, elem_bytes), [c])
            for c in choices}
    for i in range(1, len(layers)):
        nxt = {}
        for c in choices:
            lc = layer_comm(layers[i], c, W, elem_bytes)
            cands = []
            for p in choices:
                t = transition_comm(p, c, layers[i - 1].act_elems, W,
                                    elem_bytes)
                cands.append((best[p][0] + t + lc, best[p][1] + [c]))
            nxt[c] = min(cands, key=lambda x: x[0])
        best = nxt
    cost, path = min(best.values(), key=lambda x: x[0])
    return path, cost


def pure_cost(layers: Sequence[LayerCost], choice: str, W: int,
              elem_bytes: int = 4) -> float:
    return sum(layer_comm(l, choice, W, elem_bytes) for l in layers)


def brute_force(layers: Sequence[LayerCost], W: int,
                elem_bytes: int = 4) -> Tuple[List[str], float]:
    """Exhaustive reference for tests (exponential — small N only)."""
    bestc, bestp = float("inf"), None
    for assign in itertools.product("DM", repeat=len(layers)):
        c = layer_comm(layers[0], assign[0], W, elem_bytes)
        for i in range(1, len(layers)):
            c += transition_comm(assign[i - 1], assign[i],
                                 layers[i - 1].act_elems, W, elem_bytes)
            c += layer_comm(layers[i], assign[i], W, elem_bytes)
        if c < bestc:
            bestc, bestp = c, list(assign)
    return bestp, bestc


def transformer_layer_costs(d_model: int, d_ff: int, seq: int,
                            batch: int, num_layers: int) -> List[LayerCost]:
    """Chain of attention/MLP layers for a decoder stack (per-layer
    weight and activation element counts)."""
    out = []
    act = batch * seq * d_model
    for i in range(num_layers):
        out.append(LayerCost(f"attn{i}", 4 * d_model * d_model, act))
        out.append(LayerCost(f"mlp{i}", 3 * d_model * d_ff, act))
    return out
