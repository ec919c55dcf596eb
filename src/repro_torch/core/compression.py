"""Natural compression (Horvath et al., surveyed as ref 75): unbiased
stochastic rounding of gradients to powers of two.

The PyTorch counterpart of the JAX package's ``core/compression.py``.
C_nat(x) rounds |x| to one of the two nearest powers of two, with
probability proportional to the distance, so E[C_nat(x)] = x; the result
needs only a sign and an exponent, packed here into one byte (a 4x
reduction against an fp32 wire).

Randomness: ``jax.random`` bits cannot be reproduced in PyTorch, so every
function takes its uniforms explicitly (``u``, float32 in [0, 1) of x's
shape), and ``draw_uniforms`` draws a tree of them from a
``torch.Generator``, one leaf after another in the JAX package's leaf
order (sorted dict keys).

The wire format (``nc_pack``/``nc_unpack``, the kernel wrappers of
``kernels.ops``) clips the exponent code to 1..127, so it represents
magnitudes in [2^-69, 2^57] only: below that range a value rounds up to
2^-69, at or above 2^57 it saturates to 2^57.  ``natural_compress`` does
not clip; on [2^-69, 2^57) the two agree exactly.
"""
from __future__ import annotations

from typing import Any, Union

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import float_fields, pow2
from repro_torch.models.common import tree_leaves, tree_map

nc_pack = ops.nc_pack
nc_unpack = ops.nc_unpack


def natural_compress(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding to the nearest powers of two (no
    clipping), in x's dtype."""
    a = x.float().abs()
    e, p = float_fields(a)
    mag = pow2(e) * torch.where(u.float() < p, 2.0, 1.0)
    out = torch.sign(x.float()) * torch.where(a == 0, 0.0, mag)
    return out.to(x.dtype)


def uniforms_like(t: torch.Tensor, generator: torch.Generator):
    """float32 uniforms in [0, 1) of t's shape, on t's device."""
    return torch.rand(t.shape, generator=generator, dtype=torch.float32,
                      device=t.device)


def draw_uniforms(tree: Any, generator: torch.Generator) -> Any:
    """A tree of float32 uniforms in [0, 1) shaped like ``tree``'s leaves
    and on their device (the generator's), drawn leaf by leaf in
    sorted-key order."""
    return tree_map(lambda t: uniforms_like(t, generator), tree)


def wire_roundtrip(grads: Any,
                   noise: Union[Any, torch.Generator]) -> Any:
    """Every leaf through the wire format and back (``ops.nc_roundtrip``:
    the kernels on the card).  ``noise`` is a tree of uniforms shaped like
    ``grads``, or a generator that draws them leaf by leaf, just before
    each leaf is packed — the same numbers ``draw_uniforms(grads, noise)``
    would give, without holding them all at once."""
    if isinstance(noise, torch.Generator):
        return tree_map(
            lambda g: ops.nc_roundtrip(g, uniforms_like(g, noise)), grads)
    return tree_map(ops.nc_roundtrip, grads, noise)


def compress_tree(grads: Any, uniforms: Any) -> Any:
    """natural_compress on every leaf, each with its own uniforms."""
    return tree_map(natural_compress, grads, uniforms)


def wire_bytes(tree: Any, compressed: bool) -> int:
    """Bytes on the wire for one gradient exchange (fp32 or one byte)."""
    n = sum(t.numel() for t in tree_leaves(tree))
    return n * (1 if compressed else 4)
