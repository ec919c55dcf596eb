"""Roofline of a step on the H100, from work counted on meta tensors (no
device needed).

The PyTorch counterpart of the JAX package's ``core/roofline.py``.  Three
terms a step, in seconds, each a lower bound on the card's time:

    T_compute    = FLOPs a chip / PEAK_FLOPS_BF16
    T_memory     = bytes a chip / HBM_BW
    T_collective = sum over collectives of weight * result bytes / link
                   rate of the mesh dim it runs over ("model": NVLink
                   inside a node; "data" and "pod": the network)

The rates are the H100 SXM's published peaks (``launch/mesh.py``).  JAX
reads the three counts off XLA's ``cost_analysis`` of the compiled step;
PyTorch has no compiled step, so `Counter` counts them while the step
runs eagerly on ``device="meta"`` tensors, laid out as DTensors over the
mesh (a fake process group gives a mesh of any size):

- FLOPs: ``torch.utils.flop_counter``'s formulas on each op's global
  shapes, divided by the mesh dims that split the op's work (those on
  which its output is ``Shard`` or ``Partial``): a chip's share;
- bytes: each non-view op's inputs and outputs at their local shapes
  (a gather counts what it reads, twice its output, and a scatter into a
  tensor what it writes, twice its values, not the whole tensor).  The
  count is eager and unfused (every elementwise op reads and writes its
  operands), so it is higher than XLA's "bytes accessed" of a fused
  program;
- collective bytes: the result bytes of every ``_c10d_functional``
  collective, keyed ``"all-gather@model"`` by op and mesh dim, from an
  explicit redistribute or one that DTensor makes inside an op;
- memory: argument and output bytes of the plan's local shards, and as
  temp the peak of the live local bytes that the run allocated.

The five kernel wrappers (``kernels/ops.py``) do not run on meta tensors:
under a Counter each records its kernel's own work by `kernel_cost` (each
input read once, each output written once; the attention FLOPs) and
returns an empty output.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.config import ModelConfig, param_count


def model_flops(cfg: ModelConfig, seq_len: int, global_batch: int,
                kind: str) -> float:
    """Analytic 'useful' FLOPs: 6·N·D train, 2·N·D inference (N = active
    non-embedding params + lm head contribution)."""
    total, active = param_count(cfg)
    emb = cfg.vocab_size * cfg.d_model * 2
    n_active = active - emb + cfg.vocab_size * cfg.d_model  # head matmul counts
    if kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * global_batch


# per-chip link-bytes per RESULT byte on a ring: an all-reduce moves ~2x
# its result (reduce-scatter + all-gather phases); AG/RS/A2A/CP move ~1x.
COLL_WEIGHTS = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def _op_dim(key: str) -> Tuple[str, Optional[str]]:
    op, _, dim = key.partition("@")
    return op, dim or None


def weighted_coll_bytes(by_op: Dict[str, int]) -> float:
    return sum(COLL_WEIGHTS.get(_op_dim(k)[0], 1.0) * b
               for k, b in by_op.items())


def link_bw(dim: Optional[str]) -> float:
    """A mesh dim's link rate: "model" inside a node on NVLink; "data",
    "pod" (and a collective of no known dim) across nodes."""
    return NVLINK_BW if dim == "model" else NET_BW


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_by_op: Dict[str, int]
    model_flops_total: float
    peak_memory_bytes: Optional[int] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.coll_by_op and sum(self.coll_by_op.values()) > 0:
            return sum(COLL_WEIGHTS.get(op, 1.0) * b / link_bw(dim)
                       for (op, dim), b in ((_op_dim(k), b) for k, b in
                                            self.coll_by_op.items()))
        return self.coll_bytes_per_chip / NET_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_chip * self.chips
        if total <= 0:
            return float("nan")
        return self.model_flops_total / total

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_ratio=self.useful_ratio,
                 step_lower_bound=self.step_time_lower_bound)
        return d


# ---------------------------------------------------------------------------
# The kernels' own work: the Bound column of PERF.md's kernel table
# ---------------------------------------------------------------------------
def _esize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def attended_pairs(S: int, T: int, causal: bool,
                   window: Optional[int] = None) -> int:
    """(query, key) pairs a causal (query i at key position T - S + i) or
    full attention of S queries over T keys attends; a window keeps the
    last `window` keys of each query."""
    if not causal:
        return S * T
    a = T - S + 1                         # keys the first query sees
    w = window if window is not None else T
    if a > w:
        return S * w
    n = min(S, w - a + 1)                 # queries below the window cap
    return n * a + n * (n - 1) // 2 + (S - n) * w


def kernel_cost(name: str, **kw) -> Tuple[int, int]:
    """(FLOPs, bytes) of one kernel call: each input read once, each
    output written once, and the operations its result needs.

    flash_attention: q, k (shapes), dtype, causal, window.
    paged_attention: q (B, Hq, dh), pool (Np, P, Hk, dh), tables (B, n),
      dtype, resident (positions attended, summed over rows; on meta
      tensors the positions are unknown and every row counts its logical
      length).
    ssd_scan: xe (B, S, H, P), b (B, S, N), chunk, xe_dtype, b_dtype.
    nc_pack: n elements of in_dtype (fp32 uniforms beside, uint8 out).
    nc_unpack: n elements to out_dtype."""
    if name == "flash_attention":
        B, S, Hq, dh = kw["q"]
        T = kw["k"][1]
        e = _esize(kw["dtype"])
        pairs = attended_pairs(S, T, kw.get("causal", True),
                               kw.get("window"))
        return (4 * B * Hq * dh * pairs,
                e * (2 * _numel(kw["q"]) + 2 * _numel(kw["k"])))
    if name == "paged_attention":
        B, Hq, dh = kw["q"]
        Hk = kw["pool"][2]
        e = _esize(kw["dtype"])
        resident = kw["resident"]
        return (4 * Hq * dh * resident,
                2 * resident * Hk * dh * e + 2 * e * _numel(kw["q"])
                + 4 * (_numel(kw["tables"]) + B))
    if name == "ssd_scan":
        B, S, H, P = kw["xe"]
        N = kw["b"][2]
        Q = min(kw.get("chunk", 128), S)
        nc = -(-S // Q)
        tri = Q * (Q + 1) // 2
        n = _numel(kw["xe"])
        return (2 * B * nc * (tri * N + H * (tri * P + 2 * Q * N * P)),
                n * _esize(kw["xe_dtype"]) + 4 * B * S * H
                + 2 * _numel(kw["b"]) * _esize(kw["b_dtype"])
                + 4 * n + 4 * B * H * N * P)
    if name == "nc_pack":
        n = kw["n"]
        return 0, n * (_esize(kw["in_dtype"]) + 4) + n
    if name == "nc_unpack":
        n = kw["n"]
        return 0, n + n * _esize(kw["out_dtype"])
    raise KeyError(name)


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------
_COLL_OPS = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_out": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all",
             "shard_dim_alltoall": "all-to-all",
             "broadcast": "collective-permute",
             "broadcast_": "collective-permute"}
_C10D_OPS = {"allreduce_": "all-reduce", "allgather_": "all-gather",
             "_allgather_base_": "all-gather",
             "reduce_scatter_": "reduce-scatter",
             "_reduce_scatter_base_": "reduce-scatter",
             "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
             "broadcast_": "collective-permute"}
# ops that move no data: allocation, aliasing and the collectives' waits
_FREE = {"empty", "empty_strided", "empty_like", "detach", "alias",
         "lift_fresh", "_unsafe_view", "wait_tensor",
         "_wrap_tensor_autograd", "sym_size", "sym_stride", "sym_numel",
         "is_same_size", "_to_copy_meta"}

# reads of a few rows: the bytes are the rows read (the output) and the
# indices, not the whole source; writes of a few rows into a tensor: the
# values written, not the whole destination
_GATHERS = {"index", "gather", "index_select", "embedding", "take"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_copy",
             "index_copy_", "scatter", "scatter_", "index_add",
             "index_add_", "scatter_add", "scatter_add_", "index_fill_"}

_active: List["Counter"] = []


def active_counter() -> Optional["Counter"]:
    """The innermost Counter in force, or None."""
    return _active[-1] if _active else None


def _local(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Counts a chip's FLOPs, bytes and collective bytes of what runs in
    its block (see the module docstring), and the kernels' records.
    `mesh` names the collectives' groups by mesh dim."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, int] = {}
        self.largest_coll = 0        # elements of the largest one result
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self._groups = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                try:
                    self._groups[mesh.get_group(i).group_name] = name
                except Exception:  # a stand-in mesh has no groups
                    pass
        self._in_op = 0
        self._patched = []

    # -- what the run reports ----------------------------------------------
    @property
    def coll_bytes(self) -> int:
        return sum(self.coll.values())

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        """A kernel wrapper's record of one call (on meta tensors)."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        _active.append(self)
        self._patch()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()
            _active.remove(self)

    def _patch(self) -> None:
        """DTensor redistributes an op's inputs inside the op, where this
        mode is off the dispatch stack: wrap its redistribution so that
        the collectives it issues come back through the mode."""
        try:
            from torch.distributed.tensor import _dispatch
        except ImportError:      # pragma: no cover - older layouts
            return
        orig = getattr(_dispatch, "redistribute_local_tensor", None)
        if orig is None:
            return
        counter = self

        def redistribute_local_tensor(*a, **kw):
            if not counter._in_op:
                return orig(*a, **kw)
            from torch.utils._python_dispatch import (_pop_mode,
                                                      _push_mode)
            _push_mode(counter)
            try:
                return orig(*a, **kw)
            finally:
                _pop_mode()
        _dispatch.redistribute_local_tensor = redistribute_local_tensor
        self._patched.append((_dispatch, "redistribute_local_tensor", orig))

    def _unpatch(self) -> None:
        while self._patched:
            mod, name, orig = self._patched.pop()
            setattr(mod, name, orig)

    def _coll(self, key: str, results) -> None:
        self.coll[key] = self.coll.get(key, 0) + sum(_nbytes(t)
                                                     for t in results)
        self.largest_coll = max([self.largest_coll] + [
            _local(t).numel() for t in results])

    def _group_dim(self, args) -> str:
        """The mesh dim of a c10d op's process group (passed boxed)."""
        import torch.distributed as dist
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    name = dist.ProcessGroup.unbox(a).group_name
                except Exception:     # another boxed argument
                    continue
                return self._groups.get(name, "?")
        return "?"

    def _alloc(self, t) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(_local(t), self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "c10d" and name in _C10D_OPS:
            # a collective called on the process group itself (the
            # vocab-parallel embedding's all-reduce), in place
            out = func(*args, **kwargs)
            self._coll(f"{_C10D_OPS[name]}@{self._group_dim(args)}",
                       _tensors(args[0]))
            return out
        if ns in ("_c10d_functional", "_dtensor", "c10d_functional") \
                and name in _COLL_OPS:
            out = func(*args, **kwargs)
            group = next((a for a in reversed(list(args) +
                                              list(kwargs.values()))
                          if isinstance(a, str)), None)
            self._coll(f"{_COLL_OPS[name]}@{self._groups.get(group, '?')}",
                       _tensors(out))
            return out
        ins = _tensors((args, kwargs))
        dtensor = any(type(t).__name__ == "DTensor" for t in ins)
        self._in_op += dtensor
        try:
            out = func(*args, **kwargs)
        finally:
            self._in_op -= dtensor
        if name in _FREE or getattr(func, "is_view", False) or ns in ("_c10d_functional",
                                                   "c10d_functional"):
            return out
        outs = _tensors(out)
        if name in _GATHERS:
            self.bytes += 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif name in _SCATTERS:
            self.bytes += 2 * sum(_nbytes(t) for t in ins[1:])
        else:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        in_ids = {id(_local(t)) for t in ins}
        for t in outs:
            if id(_local(t)) not in in_ids:
                self._alloc(t)
        self.flops += self._flops(func, args, kwargs, out)
        return out

    def _flops(self, func, args, kwargs, out) -> int:
        from torch.utils.flop_counter import flop_registry
        f = flop_registry.get(func.overloadpacket)
        if f is None:
            return 0
        total = f(*args, **kwargs, out_val=out)
        first = next(iter(_tensors(out)), None)
        if first is None or type(first).__name__ != "DTensor":
            return int(total)
        from torch.distributed.tensor import Replicate
        split = 1
        for size, pl in zip(first.device_mesh.shape, first.placements):
            if not isinstance(pl, Replicate):
                split *= size
        return int(total) // split


def count(fn, args, mesh=None) -> Dict[str, Any]:
    """Run fn(*args) under a Counter; returns its counts, the argument
    and output bytes (local) and the temp bytes."""
    arg_bytes = sum(_nbytes(t) for t in _tensors(args))
    with Counter(mesh) as c:
        out = fn(*args)
        out_bytes = sum(_nbytes(t) for t in _tensors(out))
    return {"flops": c.flops, "bytes": c.bytes, "coll_bytes": c.coll_bytes,
            "coll_by_op": dict(c.coll), "largest_coll": c.largest_coll,
            "kernels": dict(c.kernels),
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": c.peak}
