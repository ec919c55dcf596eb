"""Dry run of the production meshes: plan every (arch x input shape) on
256 (or 512) H100s and count its roofline, with no device at all.

The PyTorch counterpart of the JAX package's ``launch/dryrun.py``.  JAX
lowers and compiles each step on 512 host devices and reads XLA's cost
and memory analyses; here the process joins the "fake" process group of
``torch.testing._internal.distributed.fake_pg`` as rank 0 of a world of
256 (or 512), builds the production mesh over it
(``launch/mesh.make_production_mesh``: (32, 8) or (2, 32, 8)), and runs
the step once on ``device="meta"`` DTensors laid out by the plan's
placements, under ``core/roofline.Counter`` (``launch/steps.cost_plan``).
Nothing is allocated and no collective moves a byte: the fake group
completes every collective at once.  The Python layer loop runs whole,
so the count is at full depth (JAX extrapolates from two reduced
depths, as XLA counts a loop body once).

Each kind runs the config its launcher runs on the card: the serve
kinds (prefill, decode, decode_cb) with the flash, paged and SSD kernels
on (the kernel wrappers record their own work on meta tensors) and the
serve path's cache layout; train with the kernels off (flash has no
backward), as ``launch/train.py`` runs it.  The three terms are the H100
SXM's published peaks applied to counted work, not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh single [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, shape_plan
from repro_torch.core import sharding as SH
from repro_torch.core.roofline import Roofline, model_flops
from repro_torch.launch.mesh import PRODUCTION, make_production_mesh
from repro_torch.launch.steps import build_plan, cost_plan


def env_for(kind: str, sp: bool = False) -> SH.AxisEnv:
    # training uses ZeRO/FSDP param+optimizer sharding; serving shards params
    # on the model axis only (weights must be resident per decode step).
    # sp=True adds Megatron-SP sequence sharding of the residual stream.
    if kind == "train":
        return SH.TRAIN_SP_ENV if sp else SH.TRAIN_ENV
    return SH.DP_TP_SP_ENV if sp else SH.DP_TP_ENV


def join_fake_world(world: int) -> None:
    """Rank 0 of a fake process group of `world` ranks (any group already
    in force is left first).  `torch.testing._internal` is internal: a
    torch without ``fake_pg`` fails here, loudly."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, PRODUCTION[multi_pod][0]))


def run_one(arch: str, shape_name: str, mesh, name: str,
            optimizer: str = "adamw", sp: bool = False, q_chunk: int = 0,
            moe_groups: int = 0) -> dict:
    shape = SHAPES[shape_name]
    cfg = shape_plan(arch, shape_name)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "status": "skipped",
                "reason": "full-attention long-context (see DESIGN.md)"}
    cfg = cfg.with_(param_dtype="bfloat16", compute_dtype="bfloat16")
    if shape.kind != "train":
        cfg = cfg.with_(use_flash_kernel=True, use_paged_kernel=True,
                        use_ssd_kernel=True)
    if q_chunk:
        cfg = cfg.with_(attn_q_chunk=q_chunk)
    if moe_groups:
        cfg = cfg.with_(moe_groups=moe_groups)
    t0 = time.time()
    with SH.axis_env(env_for(shape.kind, sp)):
        plan = build_plan(cfg, shape, mesh, optimizer=optimizer,
                          serve_layout=True)
        counts = cost_plan(plan, mesh)
    dt = time.time() - t0
    chips = 1
    for s in mesh.shape:
        chips *= s
    rf = Roofline(arch=arch, shape=shape_name, mesh=name, chips=chips,
                  flops_per_chip=float(counts["flops"]),
                  bytes_per_chip=float(counts["bytes"]),
                  coll_bytes_per_chip=float(counts["coll_bytes"]),
                  coll_by_op=counts["coll_by_op"],
                  model_flops_total=model_flops(
                      cfg, shape.seq_len, shape.global_batch, shape.kind),
                  peak_memory_bytes=int(counts["argument_bytes"]
                                        + counts["output_bytes"]
                                        + counts["temp_bytes"]))
    rec = rf.to_dict()
    rec.update(status="ok", compile_s=round(dt, 1),
               argument_bytes=int(counts["argument_bytes"]),
               output_bytes=int(counts["output_bytes"]),
               temp_bytes=int(counts["temp_bytes"]),
               kernels=counts["kernels"],
               cost_method=f"counted at full depth (L={cfg.num_layers}, "
                           f"eager, unfused)")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="Megatron-SP sequence sharding (optimized variant)")
    ap.add_argument("--q-chunk", type=int, default=0,
                    help="q-chunked attention block size (train kinds; "
                         "the serve kinds run the flash kernel)")
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="MoE routing groups (1 = survey-era global baseline)")
    ap.add_argument("--tag", default="",
                    help="suffix for the results file (e.g. '_opt')")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    import torch.distributed as dist
    try:
        for multi in meshes:
            name = mesh_name(multi)
            shape, _ = PRODUCTION[multi]
            world = 1
            for s in shape:
                world *= s
            join_fake_world(world)
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            path = outdir / f"dryrun_{name}{args.tag}.json"
            results = json.loads(path.read_text()) if path.exists() else {}
            for arch in archs:
                for shape_name in shapes:
                    key = f"{arch}|{shape_name}"
                    if args.skip_existing and key in results and \
                            results[key].get("status") in ("ok", "skipped"):
                        continue
                    try:
                        rec = run_one(arch, shape_name, mesh, name,
                                      args.optimizer, sp=args.sp,
                                      q_chunk=args.q_chunk,
                                      moe_groups=args.moe_groups)
                    except Exception as e:  # a failure is a bug in the port
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": name, "status": "FAIL",
                               "error": f"{type(e).__name__}: {e}",
                               "trace": traceback.format_exc()[-2000:]}
                    results[key] = rec
                    path.write_text(json.dumps(results, indent=1))
                    status = rec.get("status")
                    extra = ""
                    if status == "ok":
                        extra = (f"bottleneck={rec['bottleneck']} "
                                 f"tc={rec['t_compute']:.2e} "
                                 f"tm={rec['t_memory']:.2e} "
                                 f"tx={rec['t_collective']:.2e} "
                                 f"bound={rec['step_lower_bound']:.2e} "
                                 f"useful={rec['useful_ratio']:.2f} "
                                 f"count={rec['compile_s']}s")
                    elif status == "FAIL":
                        extra = rec["error"][:160]
                    print(f"[{name}] {arch} x {shape_name}: {status} {extra}",
                          flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print("dry-run complete")


if __name__ == "__main__":
    main()
