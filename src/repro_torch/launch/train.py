"""Training launcher: the non-elastic single-device loop.

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

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 25 --batch 4 --seq 64 --compress-grads
  PYTHONPATH=src python -m repro_torch.launch.train --steps 10 --batch 2 \
      --seq 4096 --compress-grads
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
      --smoke --device cpu --steps 3 --batch 2 --seq 64 --compress-grads \
      --ckpt-dir /tmp/ck --async-ckpt --trace-out /tmp/trace.json

Not ported yet: the mesh (--env/--data/--model), --elastic and --mode
(with --keep-last and the cluster flags).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.launch import cli
from repro_torch.launch.steps import make_extra, make_train_step
from repro_torch.models import model as MD
from repro_torch.obs import recorder as obs
from repro_torch.optim.optimizers import get_optimizer, warmup_cosine


def train(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20,
                    help="warmup steps of the warmup-cosine schedule")
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "sgd", "adafactor"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true",
                    help="natural compression on gradients (survey ref 75)")
    ap.add_argument("--async-ckpt", dest="async_ckpt", action="store_true",
                    default=False,
                    help="non-blocking checkpoint saves on a background "
                         "writer (repro_torch.checkpoint.AsyncCheckpointer)")
    ap.add_argument("--no-async-ckpt", dest="async_ckpt",
                    action="store_false")
    cli.add_trace_args(ap)
    args = ap.parse_args(argv)
    return cli.run_traced(args, lambda: _train(args))


def _train(args) -> dict:
    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device available")
    cfg = get_config(args.arch, smoke=args.smoke)
    if device.type == "cpu":
        # fp32 params on CPU for small-scale training stability
        cfg = cfg.with_(param_dtype="float32", compute_dtype="float32")

    opt = get_optimizer(args.optimizer,
                        warmup_cosine(args.lr, args.warmup, args.steps))
    params = MD.init_model(cfg,
                           torch.Generator(device=device).manual_seed(args.seed))
    opt_state = opt.init(params)

    step0 = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        tree, meta = restore_checkpoint(args.ckpt_dir,
                                        {"params": params, "opt": opt_state})
        params, opt_state = tree["params"], tree["opt"]
        step0 = meta.get("step", 0)
        print(f"resumed from step {step0}")

    # the step updates params and optimizer state in place, as the JAX
    # launcher's jit donates them
    step_fn = make_train_step(cfg, opt, compress_grads=args.compress_grads)
    pipe = make_pipeline(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    entropy_floor = pipe.source.entropy_nats
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
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(batches).items()}
            extra = make_extra(cfg, args.batch, device)
            if extra is not None:     # the stub frontends' zeros, as JAX
                batch["extra_embeds"] = extra
            noise = None
            if args.compress_grads:
                noise = torch.Generator(device=device).manual_seed(
                    args.seed + 1 + step)
            # the span ends after the loss is read back, so on the card
            # it holds the whole step, not its launch
            with obs.get().span("train.step", cat="train", step=step):
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch, noise)
                loss = float(metrics["loss"])
            losses.append(loss)
            if step % args.log_every == 0:
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


if __name__ == "__main__":
    from repro_torch.obs import log as _log
    _log.configure()  # CLI runs show progress; library use stays quiet
    train()
