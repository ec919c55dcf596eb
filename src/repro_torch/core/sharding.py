"""Logical-axis sharding: map logical tensor axes to mesh axes.

The PyTorch counterpart of the JAX package's ``core/sharding.py``.  Model
code names logical axes ("batch", "model", "seq", and "layers" for the
stacked layer dim) and an `AxisEnv` maps them onto the dims of whatever
mesh is active, so the survey's data, model and hybrid parallelism are
different envs over the same model code.

Here the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, and a spec is the port's own tuple: one entry per
tensor dim, each None, a mesh dim name, or a tuple of names (JAX's
``PartitionSpec`` entries).  `placements` turns a spec into one DTensor
placement per mesh dim, the counterpart of ``named_sharding``, and
`shard` redistributes a DTensor to a spec, the counterpart of
``with_sharding_constraint``.  JAX's constraint is a hint to the
partitioner; this one is a hard redistribution, with the same values.

Spec resolution needs only the mesh's dim names and sizes, so `set_mesh`
also takes any object with ``mesh_dim_names`` and ``shape`` (a fake mesh
for tests and plans).  While a real mesh is active (`use_mesh`), DTensor
ops treat plain tensors they meet (positions, masks) as replicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


@dataclasses.dataclass(frozen=True)
class AxisEnv:
    """Logical-axis -> mesh-axis mapping.

    batch:  axes the global batch is split over (data parallelism)
    model:  axes the tensor-parallel dims (heads / ffn / experts / vocab)
            are split over
    seq:    axes the sequence dim is split over (context parallelism)
    fsdp:   ZeRO/FSDP: additionally shard each param's last replicated dim
            that divides evenly over these axes (gathered at use)
    """
    batch: Axes = None
    model: Axes = None
    seq: Axes = None
    fsdp: Axes = None

    def resolve(self, name: Optional[str]) -> Axes:
        if name is None:
            return None
        # unknown logical names (e.g. "layers", the stacked dim) are never
        # mesh-sharded
        return getattr(self, name, None)


# data parallel only (survey: "data parallelism")
DP_ENV = AxisEnv(batch=("pod", "data", "model"))
# hybrid data x tensor (survey: "hybrid parallelization"), the default
DP_TP_ENV = AxisEnv(batch=("pod", "data"), model="model")
# pure tensor/model parallel (survey: "model parallelism")
TP_ENV = AxisEnv(batch=None, model=("data", "model"))
# hybrid + ZeRO param/optimizer sharding (training default for big models)
TRAIN_ENV = AxisEnv(batch=("pod", "data"), model="model", fsdp="data")
# hybrid + sequence sharding for long prefill
DP_TP_SP_ENV = AxisEnv(batch=("pod", "data"), model="model", seq="model")
# TRAIN_ENV + Megatron-SP: the residual stream is sharded over the model
# axis along the sequence dim between the TP blocks
TRAIN_SP_ENV = AxisEnv(batch=("pod", "data"), model="model", seq="model",
                       fsdp="data")

_state = threading.local()


def set_axis_env(env: AxisEnv):
    _state.env = env


def get_axis_env() -> AxisEnv:
    return getattr(_state, "env", DP_TP_ENV)


@contextlib.contextmanager
def axis_env(env: AxisEnv):
    prev = get_axis_env()
    set_axis_env(env)
    try:
        yield env
    finally:
        set_axis_env(prev)


def mesh_shape_of(mesh) -> dict:
    """{mesh dim name: size}, in mesh dim order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def get_mesh():
    """The active mesh, or None."""
    return getattr(_state, "mesh", None)


def _mesh_shape() -> dict:
    mesh = get_mesh()
    return mesh_shape_of(mesh) if mesh is not None else {}


def _mesh_axis_names() -> Tuple[str, ...]:
    return tuple(_mesh_shape())


def set_mesh(mesh):
    """Make `mesh` (a DeviceMesh, an object with ``mesh_dim_names`` and
    ``shape``, or None) the active mesh of this thread."""
    _state.mesh = mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """`mesh` active for the block; with a real DeviceMesh, plain tensors
    that meet DTensors in an op count as replicated over it."""
    prev = get_mesh()
    set_mesh(mesh)
    # implicit_replication resets DTensor's flag on exit, so only the
    # outermost block of a thread enters it
    outer = is_device_mesh(mesh) and not getattr(_state, "replicating",
                                                 False)
    try:
        if outer:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            _state.replicating = True
            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        if outer:
            _state.replicating = False
        set_mesh(prev)


def is_device_mesh(mesh) -> bool:
    if mesh is None:
        return False
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def axis_size(axes: Axes) -> int:
    shape = _mesh_shape()
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= shape.get(a, 1)
    return n


def _filter(axes: Axes, present: Tuple[str, ...]) -> Axes:
    """Drop mesh axes not present in the active mesh (e.g. 'pod' on 1 pod)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    kept = tuple(a for a in axes if a in present)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def logical(*names: Optional[str]) -> Spec:
    """A spec from logical axis names for the active env and mesh."""
    env = get_axis_env()
    present = _mesh_axis_names()
    return tuple(_filter(env.resolve(n), present) for n in names)


def resolve_spec(shape: Tuple[int, ...],
                 names: Tuple[Optional[str], ...]) -> Spec:
    """Like `logical`, but a dim that its mesh axes do not divide stays
    replicated (e.g. whisper's 51865 vocab on 16 shards)."""
    env = get_axis_env()
    present = _mesh_axis_names()
    parts = []
    for dim, name in zip(shape, names):
        axes = _filter(env.resolve(name), present)
        if axes is not None and dim % axis_size(axes) != 0:
            axes = None
        parts.append(axes)
    return tuple(parts)


def resolve_param_spec(shape: Tuple[int, ...],
                       names: Tuple[Optional[str], ...]) -> Spec:
    """`resolve_spec` + FSDP: put env.fsdp axes on the last still-replicated
    dim that divides evenly (dim 0 of stacked layer params is excluded:
    the layer loop takes one row of it at a time)."""
    env = get_axis_env()
    base = resolve_spec(shape, names)
    if env.fsdp is None:
        return base
    fs = _filter(env.fsdp, _mesh_axis_names())
    if fs is None:
        return base
    nshards = axis_size(fs)
    used = set()
    for part in base:
        if part is None:
            continue
        used.update(part if isinstance(part, tuple) else (part,))
    fs_axes = fs if isinstance(fs, tuple) else (fs,)
    if any(a in used for a in fs_axes):
        return base
    parts = list(base)
    for i in range(len(shape) - 1, -1, -1):
        if names[i] == "layers":
            continue
        if parts[i] is None and shape[i] % nshards == 0 \
                and shape[i] >= nshards:
            parts[i] = fs
            break
    return tuple(parts)


def placements(spec: Spec, mesh) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` on every mesh dim
    that the spec names for tensor dim d, ``Replicate()`` on the others.
    Axes absent from the mesh are dropped, as ``named_sharding`` does,
    and a mesh dim of size 1 splits nothing: ``Replicate()`` (DTensor
    refuses to reshape a dim "sharded" one way)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_shape_of(mesh)
    out = []
    for name in mesh.mesh_dim_names:
        if sizes[name] == 1:
            out.append(Replicate())
            continue
        dim = None
        for d, part in enumerate(spec):
            if part is not None and name in (
                    part if isinstance(part, tuple) else (part,)):
                dim = d
                break
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole(t):
    """A DTensor's whole value as a plain tensor on every rank (every
    rank must call this: it gathers), or t itself."""
    return t.full_tensor() if is_dtensor(t) else t


def shard(x, *names: Optional[str]):
    """Redistribute the DTensor `x` to the spec of `names` (a dim its mesh
    axes do not divide stays replicated).  Without an active mesh, or for
    a plain tensor, `x` is returned unchanged."""
    if get_mesh() is None or not is_dtensor(x):
        return x
    want = placements(resolve_spec(tuple(x.shape), names), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def distribute(t, spec: Spec, mesh):
    """The whole tensor `t` (the same on every rank) as a DTensor laid out
    by `spec` over `mesh`; each rank keeps its own slice, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def mesh_shards(name: str, mesh) -> int:
    """Number of shards a logical axis maps to on `mesh`."""
    axes = _filter(get_axis_env().resolve(name), tuple(mesh.mesh_dim_names))
    if axes is None:
        return 1
    shape = mesh_shape_of(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= shape[a]
    return n


def local_map(fn, args, in_names, outs):
    """fn(*locals) on each rank's own shards: the counterpart of a
    function inside shard_map, for work that is independent along the
    split dims (batch rows, heads).  Each DTensor of `args` is laid out
    by its logical names in `in_names` first; `outs` gives each output's
    global shape and logical names, so it comes back a DTensor.  An
    input that is whole on a mesh dim that splits another input gets a
    gradient summed over that dim.  Without a DTensor among `args`, fn
    runs on them as they are."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    args = [shard(a, *n) if is_dtensor(a) else a
            for a, n in zip(args, in_names)]
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    split = [any(isinstance(a.placements[m], Shard) for a in args
                 if is_dtensor(a)) for m in range(mesh.ndim)]
    local = []
    for a in args:
        if not is_dtensor(a):
            local.append(a)
            continue
        grad_pl = [Partial() if split[m] and isinstance(q, Replicate) else q
                   for m, q in enumerate(a.placements)]
        local.append(a.to_local(grad_placements=grad_pl))
    res = fn(*local)
    single = not isinstance(res, tuple)
    wrapped = tuple(
        DTensor.from_local(r, mesh,
                           placements(resolve_spec(shape, names), mesh),
                           run_check=False)
        for r, (shape, names) in zip((res,) if single else res, outs))
    return wrapped[0] if single else wrapped


def local_heads(fn, q, k, v):
    """fn(q, k, v) -> (B, S, Hq, dh) on each rank's own batch rows and
    heads: the counterpart of an attention inside shard_map.  q: (B, S,
    Hq, dh), k/v: (B, T, Hk, dh) are laid out as ("batch", None, "model",
    None); where the model axes do not divide Hk, every rank takes all
    heads.  Plain tensors go straight to fn."""
    names = ("batch", None, "model", None)
    if is_dtensor(k) and resolve_spec(tuple(k.shape), names)[2] is None:
        names = ("batch", None, None, None)
    return local_map(fn, (q, k, v), (names,) * 3,
                     [(tuple(q.shape), names)])


def local(t):
    """A DTensor's local shard (a view of it: writes land in the DTensor),
    or t itself."""
    return t.to_local() if is_dtensor(t) else t


def local_slice(t, dim: int) -> slice:
    """The global index range of this rank's shard of the DTensor `t`
    along `dim` (even splits, mesh dims taken outer to inner, as DTensor
    nests them); the whole range for a plain tensor."""
    if not is_dtensor(t):
        return slice(0, t.shape[dim])
    from torch.distributed.tensor import Shard
    dim %= t.dim()
    start, size = 0, t.shape[dim]
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim % t.dim() == dim:
            size //= t.device_mesh.size(i)
            start += t.device_mesh.get_local_rank(i) * size
    return slice(start, start + size)


def own_part(t, like):
    """This rank's shard of the whole tensor `t` (the same on every rank)
    laid out as the DTensor `like`: a view of `t`, with no communication;
    `t` itself when `like` is a plain tensor."""
    if not is_dtensor(like):
        return t
    return t[tuple(local_slice(like, d) for d in range(like.dim()))]


def from_local_like(out, like):
    """The local result `out` as a DTensor laid out as the DTensor `like`
    (its global shape follows from the even splits), or `out` itself when
    `like` is a plain tensor."""
    if not is_dtensor(like):
        return out
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out, like.device_mesh, like.placements,
                              run_check=False)


def local_shape(shape, pls, mesh) -> Tuple[int, ...]:
    """A rank's shard shape of a tensor of global `shape` laid out by the
    placements `pls` over `mesh` (even splits)."""
    loc = list(shape)
    for size, pl in zip(mesh.shape, pls):
        if hasattr(pl, "dim"):
            loc[pl.dim] //= size
    return tuple(loc)


def zeros(shape, dtype, spec: Spec, mesh, device):
    """Zeros of global `shape` laid out by `spec` over `mesh`: each rank
    allocates only its own shard.  Without a DeviceMesh, a plain
    tensor."""
    import torch
    if not is_device_mesh(mesh):
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    pls = placements(spec, mesh)
    return DTensor.from_local(
        torch.zeros(local_shape(shape, pls, mesh), dtype=dtype,
                    device=device), mesh, pls, run_check=False)
