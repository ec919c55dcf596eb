"""Step builders: the train step, prefill and decode ticks over the model,
with the sharding specs of their inputs and outputs.

The PyTorch counterpart of the JAX package's ``launch/steps.py``.
PyTorch runs eagerly, so a builder returns a plain closure where the JAX
one returns a function for ``jax.jit``.  Under a mesh (``core/sharding``)
the same closures run on DTensors: the train step's gradients are laid
out as their parameters, the global norm counts each element once, and
the update runs on each rank's own shard.  `build_plan` gives a step's
function, its inputs as ``device="meta"`` tensors and the specs and
placements of every input and output.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import InputShape
from repro_torch.core import sharding as SH
from repro_torch.core.compression import wire_roundtrip
from repro_torch.core.data_parallel import value_and_grad
from repro_torch.models import model as MD
from repro_torch.models.common import torch_dtype, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import (clip_leaf, clip_scale,
                                          get_optimizer, warmup_cosine)


# ---------------------------------------------------------------------------
# Cache and batch sharding specs
# ---------------------------------------------------------------------------
def _kv_cache_names(cfg: ModelConfig) -> tuple:
    """KV cache (L,B,C,Hk,dh) names: heads on the model axis when they
    divide it; otherwise the cache length C is split (context sharding),
    rather than a whole cache gathered again at every decode step."""
    shards = SH.axis_size(SH.get_axis_env().resolve("model"))
    if shards <= 1 or cfg.num_kv_heads % shards == 0:
        return ("layers", "batch", None, "model", None)
    return ("layers", "batch", "model", None, None)


def _cache_spec_names(cfg: ModelConfig) -> Dict[str, Any]:
    at = cfg.arch_type
    kv = _kv_cache_names(cfg)
    if at in ("dense", "vlm", "moe", "audio"):
        names = {"k": kv, "v": kv}
        if at == "audio":
            names["ck"] = kv
            names["cv"] = kv
        return names
    if at == "hybrid":
        return {"ssm": ("layers", "batch", "model", None, None),
                "conv": {"x": ("layers", "batch", None, "model"),
                         "B": ("layers", "batch", None, None),
                         "C": ("layers", "batch", None, None)},
                "sk": kv, "sv": kv}
    if at == "ssm":
        return {"wkv": ("layers", "batch", "model", None, None),
                "tm": ("layers", "batch", None),
                "cm": ("layers", "batch", None)}
    raise ValueError(at)


def _shape(leaf) -> Tuple[int, ...]:
    """A tensor's shape, or the shape of a (shape, dtype) spec."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def cache_pspecs(cfg: ModelConfig, cache_abstract, *,
                 serve: bool = False, paged: bool = False) -> Any:
    """Specs of a cache tree (tensors, or `MD.cache_specs`' (shape, dtype)
    leaves) under the active AxisEnv and mesh.

    serve=False: the JAX package's layout (KV heads, or else the cache
    length, over "model"; slots over the batch axes).  serve=True: what
    the port's serve path allocates (`MD.serve_cache_names`; with
    `paged`, an engine's page pools and per-slot rows): K/V heads over
    "model" where the stored heads divide it, each KV head repeated on
    the ranks whose query heads read it where the model axes are a
    multiple of the KV heads (`A.kv_store_heads`: the cache then holds
    that many heads), else whole, never a context split; a dense cache's
    slots over the batch axes, a pool's pages and slots on every data
    rank (the host's block tables and registers are replicated)."""
    names = (MD.serve_cache_names(cfg, cache_abstract, paged) if serve
             else _cache_spec_names(cfg))
    return tree_map(lambda leaf, nm: SH.resolve_spec(_shape(leaf), nm),
                    cache_abstract, names)


def batch_abstract(cfg: ModelConfig, B: int, S: int, train: bool = True):
    """The batch as ``device="meta"`` tensors."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    out = {"tokens": meta((B, S), torch.int32)}
    if train:
        out["labels"] = meta((B, S), torch.int32)
    if cfg.arch_type == "vlm":
        out["extra_embeds"] = meta((B, cfg.num_patches, MD.VISION_EMBED_DIM),
                                   torch.bfloat16)
    if cfg.arch_type == "audio":
        out["extra_embeds"] = meta((B, cfg.encoder_seq, cfg.d_model),
                                   torch.bfloat16)
    return out


def batch_pspecs(cfg: ModelConfig, batch_abs):
    """Every batch leaf split on its leading (batch) dim."""
    def spec(t):
        shape = _shape(t)
        return SH.resolve_spec(shape, ("batch",) + (None,) * (len(shape) - 1))
    return tree_map(spec, batch_abs)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def loss_and_grads(params, cfg: ModelConfig, batch):
    """(loss, grads) of ``lm_loss``: the port's ``jax.value_and_grad``.
    grads mirror params (a parameter that the loss does not reach gets
    zeros, as in JAX); params themselves are left untouched.  A DTensor
    parameter's gradient comes back laid out as the parameter (its
    partial sums over the data axes reduced: the data-parallel
    all-reduce)."""
    loss, grads = value_and_grad(lambda p, b: MD.lm_loss(p, cfg, b), params,
                                 batch)
    return loss, tree_map(_like_param, grads, params)


def _like_param(g, p):
    if not SH.is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)



def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _index(tree, sl):
    """The view `t[sl]` of every tensor of a tree."""
    if isinstance(tree, dict):
        return {k: _index(v, sl) for k, v in tree.items()}
    return tree[sl]


def _copy_into(dst, src) -> None:
    """Write the leaves of `src` into the tensors of `dst`, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


# elements of a leaf that an elementwise update takes at once: its fp32
# temporaries stay at 256 MB each however large the leaf (a stacked
# (L, ...) leaf of phi-3-vision-4.2b holds 1.6 G elements)
UPDATE_CHUNK = 1 << 26


def leaf_slices(p: torch.Tensor, elementwise: bool) -> list:
    """Row ranges of `p`'s leading dim of at most UPDATE_CHUNK elements,
    or the whole leaf."""
    if not elementwise or p.dim() == 0 or p.numel() <= UPDATE_CHUNK:
        return [...]
    rows = max(1, UPDATE_CHUNK // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def apply_grads(opt, params, opt_state, grads, max_norm: float = 1.0):
    """Clip to the global norm, then one optimizer update, in place: the
    leaves of `params` and `opt_state` are overwritten, a leaf at a time
    (an elementwise optimizer's in slices of UPDATE_CHUNK elements), what
    the JAX launcher's `donate_argnums=(0, 1)` lets XLA do.  Returns
    (params, opt_state, gnorm), the same objects.  A whole-tree update
    would hold the old and the new parameters and moments at once (for
    AdamW 2 x (2 + 8) bytes a bf16 parameter); this one, the temporaries
    of one slice.  The bits are the whole-tree update's: an update reads
    nothing beyond the leaf, or the slice, it writes."""
    scale, gnorm = clip_scale(grads, max_norm)
    step = opt_state["step"]
    moments = [k for k in opt_state if k != "step"]
    new_step = None
    if SH.is_dtensor(scale):
        # DTensor leaves: the norm summed over each element once; an
        # elementwise update then runs on each rank's own shard
        scale = scale.full_tensor()
    for path in _leaf_paths(params):
        p, g = _at(params, path), _at(grads, path)
        leaf = {k: _at(opt_state[k], path) for k in moments}
        if SH.is_dtensor(p) and opt.elementwise:
            p, g = p.to_local(), g.to_local()
            leaf = tree_map(lambda t: t.to_local(), leaf)
        for sl in leaf_slices(p, opt.elementwise):
            sub = {k: {"x": _index(v, sl)} for k, v in leaf.items()}
            sub["step"] = step
            new_p, new_s = opt.update({"x": clip_leaf(g[sl], scale)}, sub,
                                      {"x": p[sl]})
            p[sl].copy_(new_p["x"])
            for k in moments:
                _copy_into(_index(leaf[k], sl), new_s[k]["x"])
            new_step = new_s["step"]
    step.copy_(new_step)
    return params, opt_state, gnorm


def make_train_step(cfg: ModelConfig, opt,
                    compress_grads: bool = False) -> Callable:
    """compress_grads: every gradient leaf goes through the natural-
    compression wire format and back before the optimizer (survey ref 75;
    the nc_pack/nc_unpack kernels on the card).  The step updates its
    params and opt_state in place (`apply_grads`), so a caller must not
    hold on to them expecting the old values."""
    def train_step(params, opt_state, batch,
                   noise: Optional[Union[Any, torch.Generator]] = None):
        """noise (compress_grads only): a tree of uniforms shaped like the
        params, or a generator to draw them from, one leaf after another
        in sorted-key order.  Without it, a generator seeded with the
        optimizer's step count draws fresh noise each step, as the JAX
        step folds its step counter into a fixed key."""
        loss, grads = loss_and_grads(params, cfg, batch)
        if compress_grads:
            if noise is None:
                step = opt_state["step"]
                noise = torch.Generator(device=step.device).manual_seed(
                    int(step))
            grads = wire_roundtrip(grads, noise)
        params, opt_state, gnorm = apply_grads(opt, params, opt_state, grads)
        return params, opt_state, {"loss": SH.whole(loss),
                                   "gnorm": SH.whole(gnorm)}
    return train_step


def make_extra(cfg: ModelConfig, B: int,
               device: torch.device) -> Optional[torch.Tensor]:
    """The stub modality frontends' output, zeros in the compute dtype as
    the JAX launchers give them (its ``batch_abstract`` shapes): vlm
    patches (B, num_patches, 1024), audio frames (B, encoder_seq,
    d_model); None for the text-only families."""
    dt = torch_dtype(cfg.compute_dtype)
    if cfg.arch_type == "vlm":
        return torch.zeros((B, cfg.num_patches, MD.VISION_EMBED_DIM),
                           dtype=dt, device=device)
    if cfg.arch_type == "audio":
        return torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=dt,
                           device=device)
    return None


def make_prefill_step(cfg: ModelConfig, cache_len: int,
                      sharded_cache: bool = False) -> Callable:
    def prefill_step(params, batch):
        logits, _, cache = MD.forward(
            params, cfg, batch["tokens"],
            extra_embeds=batch.get("extra_embeds"),
            return_cache=True, cache_len=cache_len,
            sharded_cache=sharded_cache)
        return logits[:, -1:], cache
    return prefill_step


def sharded_argmax(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab dim that returns the FIRST max index on ties,
    written out as the JAX version does (bf16 logits over a large vocab do
    tie, and the two packages must pick the same token).

    On vocab-sharded DTensor logits the vocab dim stays sharded: the iota
    is a DTensor laid out as the logits' vocab dim (each rank's slice
    starts at its shard's offset), so the max and the min are reduced
    across ranks as (B,) partials, O(B) and never O(B·V) bytes."""
    m = torch.amax(logits, dim=-1, keepdim=True)
    V = logits.shape[-1]
    iota = torch.arange(V, device=logits.device, dtype=torch.int32)
    if SH.is_dtensor(logits):
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        last = logits.dim() - 1
        pl = [Shard(0) if isinstance(p, Shard) and p.dim == last
              else Replicate() for p in logits.placements]
        iota = distribute_tensor(iota, logits.device_mesh, pl,
                                 src_data_rank=None)
    cand = torch.where(logits >= m, iota, V)
    return torch.amin(cand, dim=-1).to(torch.int32)



def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = MD.decode_step(params, cfg, tokens, pos, cache)
        nxt = SH.whole(sharded_argmax(logits[:, -1]))[:, None]
        return nxt, new_cache
    return serve_step


def make_serve_cb_step(cfg: ModelConfig) -> Callable:
    """Continuous-batching decode tick: one token for EVERY pool slot.
    Retired slots are no-ops: their cache rows are kept and their token is
    passed through unchanged."""
    def serve_cb_step(params, cache, tokens, pos, active):
        logits, new_cache = MD.decode_step(params, cfg, tokens, pos, cache,
                                           active=active)
        nxt = SH.whole(sharded_argmax(logits[:, -1]))[:, None]
        nxt = torch.where(active[:, None], nxt, tokens)
        return nxt, new_cache
    return serve_cb_step


def make_paged_serve_cb_step(cfg: ModelConfig, logical_len: int) -> Callable:
    """Paged-pool variant of the continuous-batching tick: the cache's KV
    leaves are a shared page pool and each slot reads/writes through its
    block-table row.  logical_len is the dense cache_len the pool
    replaces."""
    def serve_cb_paged_step(params, cache, tokens, pos, active,
                            block_tables):
        logits, new_cache = MD.decode_step(params, cfg, tokens, pos, cache,
                                           active=active,
                                           block_tables=block_tables,
                                           logical_len=logical_len)
        nxt = SH.whole(sharded_argmax(logits[:, -1]))[:, None]
        nxt = torch.where(active[:, None], nxt, tokens)
        return nxt, new_cache
    return serve_cb_paged_step


# ---------------------------------------------------------------------------
# Step plans: the function, abstract inputs and the layout of everything
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StepPlan:
    name: str
    fn: Callable
    args: Tuple[Any, ...]          # ``device="meta"`` tensors
    in_specs: Tuple[Any, ...]      # spec trees (the port's tuples)
    out_specs: Any
    in_placements: Tuple[Any, ...]  # DTensor placements over the mesh
    out_placements: Any
    donate_argnums: Tuple[int, ...] = ()


def _placements(mesh, specs):
    return tree_map(lambda sp: SH.placements(sp, mesh), specs)


def _plan(mesh, name, fn, args, in_specs, out_specs, donate=()):
    return StepPlan(name, fn, args, in_specs, out_specs,
                    tuple(_placements(mesh, sp) for sp in in_specs),
                    _placements(mesh, out_specs), donate)


def build_plan(cfg: ModelConfig, shape: InputShape, mesh,
               optimizer: str = "adamw", serve_layout: bool = False
               ) -> StepPlan:
    """The (fn, abstract args, layouts) plan of one arch x shape.  `mesh`
    is a DeviceMesh or anything with ``mesh_dim_names`` and ``shape``;
    call under the AxisEnv the step runs in.  A scalar's spec is ().

    serve_layout: the prefill and decode plans take and give the serve
    path's caches (`cache_pspecs(serve=True)`, the prefill writing each
    rank's shard), the ones `cost_plan` can run on a mesh; by default
    the JAX package's layouts."""
    prev = SH.get_mesh()
    SH.set_mesh(mesh)      # specs resolve against it; no op runs on it
    try:
        return _build_plan(cfg, shape, mesh, optimizer, serve_layout)
    finally:
        SH.set_mesh(prev)


def cost_plan(plan: StepPlan, mesh) -> Dict[str, Any]:
    """Run the plan's step once on its meta args, laid out as DTensors by
    its placements over the DeviceMesh `mesh` (a fake process group's
    will do: nothing runs on a device), under `core.roofline.Counter`.
    Call under the AxisEnv the plan was built in.  Returns the counts
    (`roofline.count`): a chip's FLOPs, bytes and collective bytes by op
    and mesh dim, the kernels' records, and argument, output and temp
    bytes."""
    from repro_torch.core import roofline as RL

    from torch.distributed.tensor import DTensor

    def lay_out(t, pl):
        if t.dim() == 0:
            return t                  # a scalar is whole on every rank
        return DTensor.from_local(
            torch.empty(SH.local_shape(t.shape, pl, mesh), dtype=t.dtype,
                        device="meta"), mesh, pl, run_check=False)
    args = tuple(tree_map(lay_out, a, pl)
                 for a, pl in zip(plan.args, plan.in_placements))
    with SH.use_mesh(mesh):
        return RL.count(plan.fn, args, mesh)


def _build_plan(cfg, shape, mesh, optimizer, serve_layout=False):
    params_abs = MD.model_abstract(cfg)
    pspecs = MD.model_pspecs(cfg)
    B, S = shape.global_batch, shape.seq_len
    scalar = ()

    if shape.kind == "train":
        opt = get_optimizer(optimizer, warmup_cosine(3e-4, 100, 10_000))
        opt_state_abs = opt.init(params_abs)
        opt_specs = opt.state_specs(pspecs)
        batch_abs = batch_abstract(cfg, B, S, train=True)
        bspecs = batch_pspecs(cfg, batch_abs)
        return _plan(mesh, f"train[{cfg.name}x{shape.name}]",
                     make_train_step(cfg, opt),
                     (params_abs, opt_state_abs, batch_abs),
                     (pspecs, opt_specs, bspecs),
                     (pspecs, opt_specs, {"loss": scalar, "gnorm": scalar}),
                     donate=(0, 1))

    if shape.kind == "prefill":
        batch_abs = batch_abstract(cfg, B, S, train=False)
        bspecs = batch_pspecs(cfg, batch_abs)
        # the VLM prepends patch embeddings: the cache must hold them too
        S_cache = S + (cfg.num_patches if cfg.arch_type == "vlm" else 0)
        cspecs = cache_pspecs(cfg, MD.cache_specs(
            cfg, B, S_cache, _store_heads(cfg, serve_layout)),
            serve=serve_layout)
        logit_spec = SH.resolve_spec((B, 1, cfg.vocab_size),
                                     ("batch", None, "model"))
        return _plan(mesh, f"prefill[{cfg.name}x{shape.name}]",
                     make_prefill_step(cfg, S_cache, serve_layout),
                     (params_abs, batch_abs), (pspecs, bspecs),
                     (logit_spec, cspecs))

    if shape.kind in ("decode", "decode_cb"):
        cache_abs = _meta_cache(cfg, B, S, _store_heads(cfg, serve_layout))
        cspecs = cache_pspecs(cfg, cache_abs, serve=serve_layout)
        tok_abs = torch.empty((B, 1), dtype=torch.int32, device="meta")
        tok_spec = SH.resolve_spec((B, 1), ("batch", None))
        if shape.kind == "decode":
            pos_abs = torch.empty((), dtype=torch.int32, device="meta")
            return _plan(mesh, f"decode[{cfg.name}x{shape.name}]",
                         make_serve_step(cfg),
                         (params_abs, cache_abs, tok_abs, pos_abs),
                         (pspecs, cspecs, tok_spec, scalar),
                         (tok_spec, cspecs), donate=(1,))
        # continuous batching: per-slot position vector + active mask,
        # both split like the batch dim (a slot lives on one data shard)
        pos_abs = torch.empty((B,), dtype=torch.int32, device="meta")
        act_abs = torch.empty((B,), dtype=torch.bool, device="meta")
        row_spec = SH.resolve_spec((B,), ("batch",))
        return _plan(mesh, f"decode_cb[{cfg.name}x{shape.name}]",
                     make_serve_cb_step(cfg),
                     (params_abs, cache_abs, tok_abs, pos_abs, act_abs),
                     (pspecs, cspecs, tok_spec, row_spec, row_spec),
                     (tok_spec, cspecs), donate=(1,))

    raise ValueError(shape.kind)


def _meta_cache(cfg: ModelConfig, B: int, C: int, kv_heads=None):
    return tree_map(lambda s: torch.empty(s[0], dtype=s[1], device="meta"),
                    MD.cache_specs(cfg, B, C, kv_heads))


def _store_heads(cfg: ModelConfig, serve_layout: bool):
    from repro_torch.models import attention as A
    return A.kv_store_heads(cfg) if serve_layout else None
