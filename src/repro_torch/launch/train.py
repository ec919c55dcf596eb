"""Training launcher: the single-device loop, or with --elastic the elastic loops.

The PyTorch counterpart of the JAX package's ``launch/train.py``.  Runs
on the CUDA card unless ``--device cpu``.  On the card the config's dtypes
stand (bf16 parameters and compute, fp32 optimizer state) and
``--compress-grads`` sends every gradient leaf through the nc_pack /
nc_unpack kernels; on the CPU, as the JAX launcher does there, parameters
and compute are fp32 and the kernel wrappers take their plain versions.
The attention kernels have no backward, so training runs the plain
attention (the JAX launcher never sets the kernel flags either).

Compression noise for step s is drawn from a generator seeded with
``seed + 1 + s``, where the JAX launcher draws with
``PRNGKey(seed + 1 + s)``.  ``--resume`` restores params and optimizer
state from the newest checkpoint and skips the batches the restored steps
consumed, so a resumed run sees the data an uninterrupted one would.
``--async-ckpt`` hands each save to a background writer
(`repro_torch.checkpoint.AsyncCheckpointer`): the loop pays only the copy
to the host.  ``--trace-out PATH`` records the run (a ``train.step`` span
a step, which ends after the loss is read back, so on the card it is the
step's true time; the checkpointer's ``ckpt.*`` spans) and writes a
Perfetto trace, also when the run fails.

Every ``--arch`` trains: the vlm and audio batches carry the stub
frontends' zeros (`launch.steps.make_extra`), as the JAX launcher's do.
``--layers N`` cuts the model's depth to N layers and keeps its widths
(a port-only option: the JAX launcher trains the whole depth).

``--elastic`` hands the loop to `repro_torch.elastic.elastic_lm_loop`:
``--workers`` logical data-parallel workers, each with its own pipeline
shard, under a ``--failure-trace`` of fail/hang/recover/join/slow events
(the cluster flags of `launch.cli`, ``--transport sim|proc``).
``--mode`` picks the strategy: sync (checkpoint and rewind on a death;
needs ``--ckpt-dir``), local_sgd or easgd (per-worker replicas, a death
drops a row), async_ps or ssp (push/pull against a parameter server;
``--staleness`` bounds ssp's clock gap).  ``--keep-last`` bounds the
checkpoints kept, and saves are asynchronous by default under
``--elastic`` (``--no-async-ckpt`` blocks).

``--env {dp,dp_tp,tp,fsdp}`` with ``--data D --model M`` trains over a
(D, M) ``DeviceMesh`` (``core/sharding.py``: the axis env maps the
model's logical axes onto it).  When D*M > 1 the launcher spawns D*M
ranks itself: gloo on ``--device cpu``, one card a rank over NCCL on
``cuda`` (it raises with fewer cards than ranks).  Every rank draws the
same whole parameters from the seed and keeps its own shard; the batches
are the unsharded run's, split on their batch dim; rank 0 prints the
summary.  A 1x1 mesh is the unsharded step.  Every option runs on the
mesh: every rank saves (rank 0 writes the files of the same state saved
whole) and restores its own shards, rank 0 records ``--trace-out``, and
Adafactor reduces its row and column statistics across the ranks that
split them.  ``--batch`` must divide over the mesh dims the env splits
the batch over, as JAX's ``NamedSharding`` requires.  ``--elastic``
runs every mode on the mesh: the control plane is rank 0's (the
transport, its worker processes and parameter server; `launch.cli.
make_transport`), every rank steps on the same membership, sync splits
the assembled global batch as above, and the other modes keep each
logical worker's rows whole on every rank beside the params' shards.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 25 --batch 4 --seq 64 --compress-grads
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --env dp_tp --data 2 --model 2 --steps 3 --batch 8 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --env dp_tp --data 2 --model 2 --steps 4 --batch 8 --seq 32 \
      --ckpt-dir /tmp/ck --ckpt-every 2 --async-ckpt \
      --trace-out /tmp/trace.json --optimizer adafactor
  PYTHONPATH=src python -m repro_torch.launch.train --steps 10 --batch 2 \
      --seq 4096 --compress-grads
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
      --smoke --device cpu --steps 3 --batch 2 --seq 64 --compress-grads \
      --ckpt-dir /tmp/ck --async-ckpt --trace-out /tmp/trace.json
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 16 --batch 4 --seq 32 --elastic --workers 4 \
      --ckpt-dir /tmp/ck --ckpt-every 4 --keep-last 2 \
      --failure-trace trace.json [--mode local_sgd]
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --env dp_tp --data 2 --model 2 --steps 8 --batch 8 --seq 32 \
      --elastic --transport proc --ckpt-dir /tmp/ck --ckpt-every 4 \
      --failure-trace trace.json [--mode async_ps]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core import sharding as SH
from repro_torch.data import make_pipeline
from repro_torch.elastic.driver import lm_batch
from repro_torch.launch import cli
from repro_torch.launch.steps import batch_pspecs, make_train_step
from repro_torch.models import model as MD
from repro_torch.obs import recorder as obs
from repro_torch.optim.optimizers import get_optimizer, warmup_cosine

ENVS = {
    "dp": SH.DP_ENV,
    "dp_tp": SH.DP_TP_ENV,
    "tp": SH.TP_ENV,
    "fsdp": SH.TRAIN_ENV,
}


def train(argv=None) -> dict:
    args = parse_args(argv)
    if args.data * args.model > 1:
        return _train_spawned(args)
    return cli.run_traced(args, lambda: _train(args))


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags, checked."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers, widths unchanged")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20,
                    help="warmup steps of the warmup-cosine schedule")
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "sgd", "adafactor"))
    ap.add_argument("--env", default="dp_tp", choices=list(ENVS),
                    help="axis env of the mesh (core/sharding.py)")
    ap.add_argument("--data", type=int, default=1, help="data mesh dim")
    ap.add_argument("--model", type=int, default=1, help="model mesh dim")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true",
                    help="natural compression on gradients (survey ref 75)")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic training: survive worker death/join/"
                         "slowdown from a failure trace (repro_torch.elastic)")
    cli.add_cluster_args(ap, context="--elastic", workers=4,
                         workers_help="logical data-parallel workers "
                                      "for --elastic")
    cli.add_trace_args(ap)
    ap.add_argument("--mode", default="sync",
                    choices=["sync", "local_sgd", "easgd", "async_ps",
                             "ssp"],
                    help="--elastic training mode (repro_torch.elastic."
                         "modes): sync all-reduce with checkpoint/rewind "
                         "recovery (default); local_sgd/easgd per-worker "
                         "replicas with survivor continuation; async_ps/ssp "
                         "parameter-server push/pull on the cluster "
                         "transport")
    ap.add_argument("--staleness", type=int, default=2,
                    help="--mode=ssp staleness bound s: a worker may run "
                         "at most s clocks ahead of the slowest")
    ap.add_argument("--keep-last", type=int, default=3,
                    help="checkpoint retention for --elastic")
    ap.add_argument("--async-ckpt", dest="async_ckpt", action="store_true",
                    default=None,
                    help="non-blocking checkpoint saves on a background "
                         "writer (repro_torch.checkpoint.AsyncCheckpointer); "
                         "default: on for --elastic, off otherwise")
    ap.add_argument("--no-async-ckpt", dest="async_ckpt",
                    action="store_false")
    args = ap.parse_args(argv)
    depth = get_config(args.arch, smoke=args.smoke).num_layers
    if args.layers is not None and not 1 <= args.layers <= depth:
        ap.error(f"--layers {args.layers}: {args.arch} has {depth} layers")
    if args.elastic and args.mode == "sync" and not args.ckpt_dir:
        ap.error("--elastic --mode=sync requires --ckpt-dir (sync "
                 "recovery restores from the last checkpoint); other "
                 "modes checkpoint only when --ckpt-dir is given")
    if args.async_ckpt is None:
        # elastic checkpoints every few steps: a blocking save there
        # steals a whole step from every worker, so async is the default
        args.async_ckpt = args.elastic
    shards = _batch_shards(args)
    if args.batch % shards:
        ap.error(f"--batch {args.batch}: the {args.env} env splits the "
                 f"batch over {shards} ranks of the mesh")
    return args


def _batch_shards(args) -> int:
    """The ranks of the (--data, --model) mesh that split the batch under
    --env."""
    axes = ENVS[args.env].batch or ()
    sizes = {"data": args.data, "model": args.model}
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes.get(a, 1)
    return n


def _train_spawned(args) -> dict:
    """data*model ranks, one process each; rank 0's summary."""
    import torch.multiprocessing as mp
    world = args.data * args.model
    device = resolve_device(args.device)
    if device.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world:
            raise RuntimeError(f"--data {args.data} --model {args.model} "
                               f"needs {world} CUDA devices, one a rank; "
                               f"{n} found")
    # the ranks share this process's intra-op threads
    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(args, world, tmp, threads), nprocs=world,
                 join=True)
        with open(os.path.join(tmp, "summary.json")) as f:
            return json.load(f)


def _rank_main(rank: int, args, world: int, tmp: str,
               threads: int) -> None:
    import logging

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_device_mesh, make_host_mesh
    # DTensor's notes on gloo's missing all-to-all and on per-dim
    # all-reduces are not a run's business
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    cpu = resolve_device(args.device).type == "cpu"
    if cpu:
        torch.set_num_threads(threads)
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world)
    try:
        mesh = (make_host_mesh if cpu else make_device_mesh)(args.data,
                                                            args.model)
        out = cli.run_traced(args, lambda: _train(args, mesh=mesh))
        if rank == 0:
            ls = out["losses"]
            print(f"trained {len(ls)} steps on a {args.data}x{args.model} "
                  f"{args.env} mesh ({world} ranks, {args.device}): loss "
                  f"{ls[0]:.4f} -> {ls[-1]:.4f}", flush=True)
            res = {"losses": out["losses"],
                   "entropy_floor": out["entropy_floor"],
                   "env": args.env, "mesh": [args.data, args.model]}
            if args.elastic:
                res.update(final_alive=list(out["final_alive"]),
                           transitions=out["transitions"],
                           recoveries=[dataclasses.astuple(r) for r in
                                       out["recoveries"]])
            with open(os.path.join(tmp, "summary.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _train(args, mesh=None) -> dict:
    """The loop; with `mesh`, on this rank's shards of it (every rank of
    the mesh runs it)."""
    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device available")
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    main = mesh is None or torch.distributed.get_rank() == 0
    env = ENVS[args.env]
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = cfg.with_(num_layers=args.layers)
    if device.type == "cpu":
        # fp32 params on CPU for small-scale training stability
        cfg = cfg.with_(param_dtype="float32", compute_dtype="float32")

    opt = get_optimizer(args.optimizer,
                        warmup_cosine(args.lr, args.warmup, args.steps))
    params = MD.init_model(cfg,
                           torch.Generator(device=device).manual_seed(args.seed))
    if mesh is not None:
        # whole on every rank from the seed, then each keeps its shard
        with SH.axis_env(env):
            params = MD.distribute_params(params, cfg, mesh)
    opt_state = opt.init(params)

    step0 = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        tree, meta = restore_checkpoint(args.ckpt_dir,
                                        {"params": params, "opt": opt_state})
        params, opt_state = tree["params"], tree["opt"]
        step0 = meta.get("step", 0)
        if main:
            print(f"resumed from step {step0}")

    # the step updates params and optimizer state in place, as the JAX
    # launcher's jit donates them
    step_fn = make_train_step(cfg, opt, compress_grads=args.compress_grads)
    pipe = make_pipeline(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    entropy_floor = pipe.source.entropy_nats

    def place(b):
        """A numpy batch as the step takes it (on a mesh, split)."""
        batch = lm_batch(cfg, b, device)
        return batch if mesh is None else _split_batch(batch, cfg, mesh, env)

    if args.elastic:
        from repro_torch.elastic import elastic_lm_loop
        with _on_mesh(mesh, env):
            out = elastic_lm_loop(
                args=args, cfg=cfg, step_fn=step_fn, params=params,
                opt_state=opt_state,
                pipe_factory=lambda shard, num: make_pipeline(
                    cfg.vocab_size, args.batch, args.seq, shard_id=shard,
                    num_shards=num, seed=args.seed),
                step0=step0, opt=opt,
                loss_fn=lambda p, b: MD.lm_loss(p, cfg, b), device=device,
                mesh=mesh, place=place)
        return {"losses": out["losses"], "entropy_floor": entropy_floor,
                "params": out["params"], "recoveries": out["recoveries"],
                "final_alive": out["final_alive"],
                "transitions": out["transitions"]}
    batches = iter(pipe)
    for _ in range(step0):       # the batches the restored steps consumed
        next(batches)

    saver = (AsyncCheckpointer(args.ckpt_dir)
             if args.async_ckpt and args.ckpt_dir else None)

    def _save(at_step):
        tree = {"params": params, "opt": opt_state}
        meta = {"step": at_step, "arch": args.arch}
        if saver is not None:
            saver.save(at_step, tree, meta)
        else:
            save_checkpoint(args.ckpt_dir, at_step, tree, meta)

    losses = []
    t0 = time.time()
    try:
        for i in range(args.steps):
            step = step0 + i
            batch = place(next(batches))
            noise = None
            if args.compress_grads:
                noise = torch.Generator(device=device).manual_seed(
                    args.seed + 1 + step)
            # the span ends after the loss is read back, so on the card
            # it holds the whole step, not its launch
            with obs.get().span("train.step", cat="train", step=step), \
                    _on_mesh(mesh, env):
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch, noise)
                loss = float(metrics["loss"])
            losses.append(loss)
            if main and step % args.log_every == 0:
                dt = time.time() - t0
                print(f"step {step:5d} loss {loss:.4f} "
                      f"(floor~{entropy_floor:.3f}) "
                      f"gnorm {float(metrics['gnorm']):.3f} "
                      f"{dt / max(i, 1):.2f}s/step", flush=True)
            if (args.ckpt_dir and args.ckpt_every
                    and (step + 1) % args.ckpt_every == 0):
                _save(step + 1)
        if args.ckpt_dir:
            _save(step0 + args.steps)
        if saver is not None:
            saver.wait()  # barrier: the final save is durable on return
    finally:
        if saver is not None:
            saver.close(wait=False)  # never leak the writer thread
    return {"losses": losses, "entropy_floor": entropy_floor,
            "params": params}


@contextlib.contextmanager
def _on_mesh(mesh, env):
    """`mesh` and `env` active for the block; nothing without a mesh."""
    if mesh is None:
        yield
        return
    with SH.use_mesh(mesh), SH.axis_env(env):
        yield


def _split_batch(batch, cfg, mesh, env):
    with _on_mesh(mesh, env):
        specs = batch_pspecs(cfg, batch)
    return {k: SH.distribute(v, specs[k], mesh) for k, v in batch.items()}


if __name__ == "__main__":
    from repro_torch.obs import log as _log
    _log.configure()  # CLI runs show progress; library use stays quiet
    train()
