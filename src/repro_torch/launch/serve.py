"""Serving launcher: static batched serving or continuous batching.

The PyTorch counterpart of the JAX package's ``launch/serve.py``.

Static (default): a batch of requests is prefilled once, then decoded
token by token in lockstep behind one scalar position.

Continuous (--continuous): the `repro_torch.serving.ServeEngine` slot
pool, dense or paged (--paged), with FIFO admission that backfills a slot
the moment its request retires.  With --speculative the pool decodes by
draft-verify rounds (`repro_torch.serving.SpecDecodeEngine`): an n-gram
lookup draft, or with --draft-arch a smaller model of the same vocabulary
(weights from --seed + 7).

Elastic fleet (--replicas N): N continuous-batching replicas behind the
straggler-aware router (`repro_torch.serving.ServeFleet`), sharing one
parameter set and one `ServeProgram`, driven by the same trace-driven
membership machine as elastic training: a replica's death drains its
in-flight requests and re-admits them across the survivors (with --paged
their KV pages migrate), a SUSPECT replica is drained preemptively, or
with --hedged keeps its work while a backup copy races it on a healthy
replica.  --failure-trace replays crash / hang / recover / join / slow
events; without one the fleet runs failure-free.

Runs on the CUDA card (the attention kernels, and for the hybrid family
the SSD scan kernel, on) unless --device cpu, where the kernel wrappers
take their plain PyTorch versions.  --arch takes every config of the
registry: qwen3-0.6b, qwen3-1.7b, deepseek-7b, nemotron-4-340b (dense;
nemotron's 341.0B params need more than one card), qwen3-moe-30b-a3b,
arctic-480b (MoE; arctic's 476.9B params need more than one card),
zamba2-1.2b (hybrid), rwkv6-1.6b (ssm: no KV, so not --paged),
whisper-tiny (audio) and phi-3-vision-4.2b (vlm).  The audio and vlm
requests carry zero frames / patches from the stub frontends, as in the
JAX launcher, and a vlm cache holds the patch prefix too.  The hybrid
family prefills any prompt length: its chunked scan takes a ragged last
chunk, where the JAX package asserts a whole number of chunks.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --batch 4 \
      --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous --paged \
      --requests 16 --batch 8 --prompt-len 512 --gen 128
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --continuous --requests 6 --batch 2 --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --continuous --paged --requests 16 --batch 8 --prompt-len 512 --gen 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --continuous --paged --speculative --draft-arch qwen3-0.6b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-30b-a3b --continuous --paged --requests 16 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --smoke --device cpu --continuous --requests 6 --batch 2
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --replicas 3 --paged --page-size 4 --requests 12 --batch 2 \
      --prompt-len 16 --gen 8 --failure-trace trace.json [--hedged]

--trace-out PATH records the run (the engine's `serve.*` events and
`request` spans) and writes a Perfetto trace, also when the run fails.

--data D --model M serves every mode on a (D, M) mesh under
``core.sharding.DP_TP_ENV``, as the JAX launcher does: the weights are
drawn whole from --seed on every rank and each keeps its shard, the
attention kernels run on each rank's local heads, and the caches and
page pools are split on their K/V heads (``launch/steps.cache_pspecs``
with serve=True).  With D*M > 1 the launcher spawns D*M ranks itself
(gloo on the CPU, NCCL with one card a rank), each running the same
stream; rank 0 prints the summary.  `serve(argv, mesh=...)` runs on a
mesh over a group the caller initialised (a world of one, say).

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --continuous --paged --page-size 4 --requests 6 --batch 2 \
      --prompt-len 16 --gen 8 --data 2 --model 2
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import sharding as SH
from repro_torch.launch import cli
from repro_torch.launch.steps import (make_extra, make_serve_step,
                                      sharded_argmax)
from repro_torch.models import model as MD


def make_static_fns(cfg, cache_len, extra=None):
    """(prefill, decode) pair for the static serve path."""
    serve_step = make_serve_step(cfg)

    def prefill(params, tokens):
        logits, _, cache = MD.forward(
            params, cfg, tokens, extra_embeds=extra, return_cache=True,
            cache_len=cache_len, sharded_cache=SH.is_dtensor(params["embed"]))
        return SH.whole(sharded_argmax(logits[:, -1]))[:, None], cache

    def decode(params, tok, pos, cache):
        return serve_step(params, cache, tok, pos)

    return prefill, decode


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_static(params, cfg, args, device):
    B, S, G = args.batch, args.prompt_len, args.gen
    # the vlm cache holds the patch prefix before the prompt tokens
    P = MD.n_prefix(cfg)
    cache_len = S + G + P
    rng = np.random.RandomState(args.seed + 1)
    prompts = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(B, S)),
                              device=device)
    prefill, decode = make_static_fns(cfg, cache_len,
                                      make_extra(cfg, B, device))

    t0 = time.time()
    tok, cache = prefill(params, prompts)
    _sync(device)
    t_prefill = time.time() - t0
    out = [tok]
    t0 = time.time()
    for i in range(G - 1):
        tok, cache = decode(params, tok, P + S + i, cache)
        out.append(tok)
    _sync(device)
    t_decode = time.time() - t0

    gen = torch.cat(out, dim=1).cpu().numpy()
    tput = B * (G - 1) / max(t_decode, 1e-9)
    print(f"arch={cfg.name} device={device} B={B} prompt={S} gen={G}")
    print(f"prefill: {t_prefill:.3f}s   decode: {t_decode:.3f}s "
          f"({tput:.1f} tok/s)")
    print("sample generation (first request):", gen[0, :16].tolist())
    return {"generated": gen, "t_prefill": t_prefill, "t_decode": t_decode}


def _stream_lens(args):
    """(prompt lengths, budgets) the continuous stream draws from."""
    S, G = args.prompt_len, args.gen
    plens = sorted({min(S, max(1, S // 2)), min(S, max(1, 3 * S // 4)), S})
    gens = sorted({max(1, G // 4), max(1, G // 2), G})
    return plens, gens


def _make_stream(cfg, args, device, requests=None):
    """Deterministic mixed-length request stream (as the JAX launcher);
    vlm and audio requests carry the stub frontend's zeros."""
    from repro_torch.serving import Request

    if requests is not None:
        return list(requests)
    rng = np.random.RandomState(args.seed + 1)
    plens, gens = _stream_lens(args)
    return [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab_size,
                                       size=int(rng.choice(plens))),
                    max_new_tokens=int(rng.choice(gens)),
                    extra_embeds=make_extra(cfg, 1, device))
            for i in range(args.requests)]


def _serve_fleet(params, cfg, args, device, requests=None):
    from repro_torch.serving import ServeFleet

    trace = cli.load_failure_trace(args)
    transport = (cli.make_transport(args, trace, device)
                 if args.transport == "proc" else None)
    fleet = ServeFleet(params, cfg, replicas=args.replicas,
                       num_slots=args.batch,
                       cache_len=args.prompt_len + args.gen
                       + MD.n_prefix(cfg),
                       trace=None if transport else trace,
                       transport=transport,
                       page_size=args.page_size if args.paged else None,
                       num_pages=args.num_pages if args.paged else None,
                       hedged_decode=args.hedged, device=device)
    reqs = _make_stream(cfg, args, device, requests)
    t0 = time.time()
    try:
        finished = fleet.run(reqs)
        _sync(device)
    finally:
        fleet.close()
    dt = time.time() - t0
    st = fleet.stats()
    print(f"arch={cfg.name} device={device} replicas={args.replicas} "
          f"slots={args.batch} requests={args.requests} trace="
          f"{args.failure_trace or '<failure-free>'}")
    print(f"fleet: {dt:.3f}s wall={st['wall']} ticks  "
          f"{st['delivered_tokens']} tokens "
          f"({st['delivered_tokens'] / max(dt, 1e-9):.1f} tok/s)  "
          f"goodput={st['goodput']:.2f} tok/wall-tick  "
          f"drains={st['drains']} readmitted={st['readmitted']}  "
          f"survivors={st['replicas']}")
    print(f"routing: {st['routed']}")
    print("sample generation (first request):", finished[0].tokens[:16])
    return {"finished": finished, "stats": st, "t_total": dt,
            "engine_stats": fleet.engine_stats()}


def _serve_continuous(params, cfg, args, device, requests=None):
    from repro_torch.serving import (LookupDraft, ModelDraft, ServeEngine,
                                     SpecDecodeEngine)

    # drawn lengths never exceed the CLI bounds: cache_len = S + G (and a
    # vlm's patch prefix) holds the longest prompt plus the largest budget
    S, G = args.prompt_len, args.gen
    reqs = _make_stream(cfg, args, device, requests)
    cache_len = S + G + MD.n_prefix(cfg)
    paged = dict(page_size=args.page_size,
                 num_pages=args.num_pages) if args.paged else {}
    if args.speculative:
        if args.draft_arch:
            dcfg = _device_config(args.draft_arch, args.smoke, device)
            dparams = MD.init_model(dcfg, torch.Generator(
                device=device).manual_seed(args.seed + 7))
            if SH.is_dtensor(params["embed"]):
                dparams = MD.distribute_params(dparams, dcfg, SH.get_mesh())
            draft = ModelDraft(dparams, dcfg)
        else:
            draft = LookupDraft()
        engine = SpecDecodeEngine(params, cfg, num_slots=args.batch,
                                  cache_len=cache_len + args.spec_k,
                                  draft=draft, spec_k=args.spec_k,
                                  device=device, **paged)
    else:
        engine = ServeEngine(params, cfg, num_slots=args.batch,
                             cache_len=cache_len, device=device, **paged)
    t0 = time.time()
    finished = engine.run(reqs)
    _sync(device)
    dt = time.time() - t0
    st = engine.stats()
    tput = st["generated_tokens"] / max(dt, 1e-9)
    print(f"arch={cfg.name} device={device} slots={args.batch} "
          f"requests={args.requests} prompt<=~{S} gen<={G}")
    print(f"continuous: {dt:.3f}s  {st['generated_tokens']} tokens "
          f"({tput:.1f} tok/s)  occupancy={st['occupancy']:.2f}  "
          f"ticks={st['ticks']} (prefill {st['prefill_ticks']}, "
          f"decode {st['decode_ticks']})")
    if args.paged:
        print(f"paged: page_size={engine.page_size} "
              f"pages={engine.num_pages} "
              f"pool_occupancy={st['pool_occupancy']:.2f} "
              f"preemptions={st['preemptions']}")
    if args.speculative:
        draft = f"model:{args.draft_arch}" if args.draft_arch else "lookup"
        print(f"speculative: k={args.spec_k} draft={draft} "
              f"rounds={st['spec_rounds']} "
              f"accept_rate={st['accept_rate']:.2f} "
              f"tokens/round={st['tokens_per_round']:.2f}")
    print("sample generation (first request):", finished[0].tokens[:16])
    return {"finished": finished, "stats": st, "t_total": dt,
            "engine": engine}


def serve(argv=None, *, mesh=None, requests=None, params=None) -> dict:
    """The launcher.  With `mesh` (a (data, model) DeviceMesh over a group
    the caller initialised, matching --data/--model) it serves on it in
    this process; `requests` replaces the launcher's own stream
    (--continuous / --replicas); `params`, a tree of numpy arrays
    (`bridge.params_to_numpy`, or the JAX package's weights), replaces
    the weights drawn from --seed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--batch", type=int, default=4,
                    help="static: batch size; continuous: pool slots")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a slot pool "
                         "(repro_torch.serving.ServeEngine)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="elastic fleet of N continuous-batching replicas "
                         "(repro_torch.serving.ServeFleet); --batch = slots "
                         "per replica")
    ap.add_argument("--requests", type=int, default=16,
                    help="--continuous/--replicas: requests in the stream")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV-cache pool: slots share fixed-size "
                         "pages instead of reserving max-length rows")
    ap.add_argument("--page-size", type=int, default=16,
                    help="--paged: tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="--paged: pool pages (default: worst-case "
                         "slots x ceil(cache_len/page_size))")
    ap.add_argument("--speculative", action="store_true",
                    help="--continuous: draft-verify decoding "
                         "(repro_torch.serving.SpecDecodeEngine); the same "
                         "greedy stream, fewer target passes")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="--speculative: draft tokens per round")
    ap.add_argument("--draft-arch", default=None,
                    help="--speculative: ported arch drafting for --arch "
                         "(e.g. qwen3-0.6b for qwen3-1.7b); default: "
                         "model-free n-gram lookup draft")
    ap.add_argument("--hedged", action="store_true",
                    help="--replicas: hedged decode: SUSPECT replicas "
                         "keep serving while a backup continuation races "
                         "them on a healthy replica (first token wins)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks of the (data, model) mesh")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel ranks of the (data, model) mesh")
    ap.add_argument("--seed", type=int, default=0)
    cli.add_cluster_args(ap, context="--replicas")
    cli.add_trace_args(ap)
    args = ap.parse_args(argv)
    if mesh is not None and tuple(mesh.shape) != (args.data, args.model):
        ap.error(f"mesh {tuple(mesh.shape)} != --data {args.data} --model "
                 f"{args.model}")
    if mesh is None and args.data * args.model > 1:
        if args.transport == "proc":
            ap.error("--transport proc runs its replicas in worker "
                     "processes; under a mesh only 'sim' is ported")
        if args.trace_out:
            ap.error("--trace-out is not ported for a mesh larger than 1x1 "
                     "(--data/--model)")
        return _serve_spawned(args, params)
    return cli.run_traced(args, lambda: _serve(args, mesh, requests, params))


def _device_config(arch, smoke, device):
    """The arch's config for `device`: the kernels on the card, fp32 on
    the CPU."""
    cfg = get_config(arch, smoke=smoke)
    if device.type == "cuda":
        return cfg.with_(use_flash_kernel=True, use_paged_kernel=True,
                         use_ssd_kernel=True)
    return cfg.with_(param_dtype="float32", compute_dtype="float32")


def _serve(args, mesh=None, requests=None, weights=None) -> dict:
    """One serve run; with `mesh`, this rank's part of it (every rank of
    the mesh runs it, on the same stream).  `weights`: numpy params to
    serve instead of the --seed draw."""
    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device available")
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = _device_config(args.arch, args.smoke, device)
    if weights is not None:
        from repro_torch.bridge import params_from_numpy
        params = params_from_numpy(weights, device)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = MD.init_model(cfg, gen)
    scope = contextlib.ExitStack()
    if mesh is not None:
        scope.enter_context(SH.axis_env(SH.DP_TP_ENV))
        # whole on every rank from the seed, then each keeps its shard
        params = MD.distribute_params(params, cfg, mesh)
        scope.enter_context(SH.use_mesh(mesh))
    with scope, torch.no_grad():
        if args.replicas:
            return _serve_fleet(params, cfg, args, device, requests)
        if args.continuous:
            return _serve_continuous(params, cfg, args, device, requests)
        return _serve_static(params, cfg, args, device)


def _serve_spawned(args, weights=None) -> dict:
    """data*model ranks, one process each, every rank on the same stream;
    rank 0's summary: the generated tokens by request, the stats, and for
    --continuous the cache leaves' placements beside `cache_pspecs`'."""
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
        mp.spawn(_rank_main, args=(args, world, tmp, threads, weights),
                 nprocs=world, join=True)
        with open(os.path.join(tmp, "summary.json")) as f:
            return json.load(f)


def summary(out: dict) -> dict:
    """A run's result as plain data: tokens by request id (static: the
    batch's rows), stats, and the engine cache's placements and specs."""
    res = {"mode": "static" if "generated" in out else "stream"}
    if "generated" in out:
        res["tokens"] = {str(i): row.tolist()
                         for i, row in enumerate(out["generated"])}
    else:
        res["tokens"] = {str(f.rid): list(map(int, f.tokens))
                         for f in out["finished"]}
        res["stats"] = {k: v for k, v in out["stats"].items()
                        if isinstance(v, (int, float, str))}
    eng = out.get("engine")
    if eng is not None and SH.is_dtensor(next(iter(eng.cache.values()))):
        from repro_torch.launch.steps import cache_pspecs
        from repro_torch.models.common import tree_leaves
        mesh = next(iter(eng.cache.values())).device_mesh
        specs = tree_leaves(cache_pspecs(eng.cfg, eng.cache, serve=True,
                                         paged=eng.paged))
        res["placements"] = [
            [repr(t.placements), repr(SH.placements(sp, mesh)),
             list(t.shape)]
            for t, sp in zip(tree_leaves(eng.cache), specs)]
    return res


def _rank_main(rank: int, args, world: int, tmp: str, threads: int,
               weights=None) -> None:
    import logging
    import sys

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_device_mesh, make_host_mesh
    # DTensor's notes on gloo's missing all-to-all are not a run's business
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    cpu = resolve_device(args.device).type == "cpu"
    if cpu:
        torch.set_num_threads(threads)
    else:
        torch.cuda.set_device(rank)
    if rank:
        sys.stdout = open(os.devnull, "w")   # rank 0 prints the summary
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world)
    try:
        mesh = (make_host_mesh if cpu else make_device_mesh)(args.data,
                                                            args.model)
        out = _serve(args, mesh, weights=weights)
        with SH.axis_env(SH.DP_TP_ENV), SH.use_mesh(mesh):
            res = summary(out)
        if rank == 0:
            print(f"served on a {args.data}x{args.model} mesh ({world} "
                  f"ranks, {args.device})", flush=True)
            with open(os.path.join(tmp, "summary.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    from repro_torch.obs import log as _log
    _log.configure()  # CLI runs show progress; library use stays quiet
    serve()
