"""Meshes over an initialised process group, and the Hopper production
mesh.

The PyTorch counterpart of the JAX package's ``launch/mesh.py``: a
``DeviceMesh`` with dim names over the ranks of ``torch.distributed``'s
default group, which the caller has initialised (gloo on the CPU, NCCL
with one card a rank, or the fake group of
``torch.testing._internal.distributed.fake_pg`` for a dry run).

The production mesh is 256 H100s as (32, 8) ("data", "model"), or two
such clusters, 512 cards, as (2, 32, 8) ("pod", "data", "model").  The
"model" dim is 8, not the TPU's 16: tensor parallelism moves activations
at every layer, so it stays inside one HGX node's NVLink domain of 8
cards; "data" and "pod" cross the nodes' network, where only the
gradient reduction and other low-volume collectives run.
"""
from __future__ import annotations

AXES = ("data", "model")

# NVIDIA H100 SXM5 constants, per card: the roofline's rates
# (core/roofline.py).  Published peaks, not measurements.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores (H100 SXM data sheet)
HBM_BW = 3.35e12          # B/s, HBM3 (H100 SXM data sheet)
NVLINK_BW = 450e9         # B/s each way, NVLink 4 inside an 8-card HGX node
NET_BW = 50e9             # B/s, one 400 Gb/s NDR InfiniBand port a card

PRODUCTION = {False: ((32, 8), ("data", "model")),
              True: ((2, 32, 8), ("pod", "data", "model"))}


def _world(n: int, shape) -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                         f"process group has {world}")
    return world


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(32, 8) ("data", "model") over 256 ranks, or (2, 32, 8) ("pod",
    "data", "model") over 512: the default group must have that many
    (NCCL in production; the fake group, with device_type "cpu", in the
    dry run, whose tensors live on the meta device)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = PRODUCTION[multi_pod]
    n = 1
    for s in shape:
        n *= s
    _world(n, shape)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1):
    """A CPU mesh over a gloo group of data*model ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    _world(data * model, (data, model))
    return init_device_mesh("cpu", (data, model), mesh_dim_names=AXES)


def make_device_mesh(data: int = 1, model: int = 1):
    """A CUDA mesh over an NCCL group of data*model ranks, one card a rank
    (rank r on card r of its host)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    world = _world(data * model, (data, model))
    if torch.cuda.device_count() < world:
        raise RuntimeError(f"a ({data}, {model}) mesh needs {world} CUDA "
                           f"devices; {torch.cuda.device_count()} found")
    return init_device_mesh("cuda", (data, model), mesh_dim_names=AXES)
