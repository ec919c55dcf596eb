"""Meshes over an initialised process group.

The PyTorch counterpart of the host-mesh half of the JAX package's
``launch/mesh.py``: a ``(data, model)`` ``DeviceMesh`` with dim names
"data" and "model" over the ranks of ``torch.distributed``'s default
group, which the caller has initialised (gloo on the CPU, NCCL with one
card a rank).  The TPU constants and the production mesh of the JAX
module have Hopper counterparts to come (ROADMAP.md, queue 1).
"""
from __future__ import annotations

AXES = ("data", "model")


def _world(data: int, model: int) -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    return world


def make_host_mesh(data: int = 1, model: int = 1):
    """A CPU mesh over a gloo group of data*model ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    _world(data, model)
    return init_device_mesh("cpu", (data, model), mesh_dim_names=AXES)


def make_device_mesh(data: int = 1, model: int = 1):
    """A CUDA mesh over an NCCL group of data*model ranks, one card a rank
    (rank r on card r of its host)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    world = _world(data, model)
    if torch.cuda.device_count() < world:
        raise RuntimeError(f"a ({data}, {model}) mesh needs {world} CUDA "
                           f"devices; {torch.cuda.device_count()} found")
    return init_device_mesh("cuda", (data, model), mesh_dim_names=AXES)
