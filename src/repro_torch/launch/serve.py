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

--trace-out PATH records the run (the engine's `serve.*` events and
`request` spans) and writes a Perfetto trace, also when the run fails.

Not ported yet: --replicas, --hedged and the transports.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch import cli
from repro_torch.launch.steps import (make_extra, make_serve_step,
                                      sharded_argmax)
from repro_torch.models import model as MD


def make_static_fns(cfg, cache_len, extra=None):
    """(prefill, decode) pair for the static serve path."""
    serve_step = make_serve_step(cfg)

    def prefill(params, tokens):
        logits, _, cache = MD.forward(params, cfg, tokens,
                                      extra_embeds=extra,
                                      return_cache=True,
                                      cache_len=cache_len)
        return sharded_argmax(logits[:, -1])[:, None], cache

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


def _make_stream(cfg, args, device):
    """Deterministic mixed-length request stream (as the JAX launcher);
    vlm and audio requests carry the stub frontend's zeros."""
    from repro_torch.serving import Request

    rng = np.random.RandomState(args.seed + 1)
    plens, gens = _stream_lens(args)
    return [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab_size,
                                       size=int(rng.choice(plens))),
                    max_new_tokens=int(rng.choice(gens)),
                    extra_embeds=make_extra(cfg, 1, device))
            for i in range(args.requests)]


def _serve_continuous(params, cfg, args, device):
    from repro_torch.serving import (LookupDraft, ModelDraft, ServeEngine,
                                     SpecDecodeEngine)

    # drawn lengths never exceed the CLI bounds: cache_len = S + G (and a
    # vlm's patch prefix) holds the longest prompt plus the largest budget
    S, G = args.prompt_len, args.gen
    reqs = _make_stream(cfg, args, device)
    cache_len = S + G + MD.n_prefix(cfg)
    paged = dict(page_size=args.page_size,
                 num_pages=args.num_pages) if args.paged else {}
    if args.speculative:
        if args.draft_arch:
            dcfg = _device_config(args.draft_arch, args.smoke, device)
            dparams = MD.init_model(dcfg, torch.Generator(
                device=device).manual_seed(args.seed + 7))
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
    return {"finished": finished, "stats": st, "t_total": dt}


def serve(argv=None) -> dict:
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
    ap.add_argument("--requests", type=int, default=16,
                    help="--continuous: requests in the stream")
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
    ap.add_argument("--seed", type=int, default=0)
    cli.add_trace_args(ap)
    args = ap.parse_args(argv)
    return cli.run_traced(args, lambda: _serve(args))


def _device_config(arch, smoke, device):
    """The arch's config for `device`: the kernels on the card, fp32 on
    the CPU."""
    cfg = get_config(arch, smoke=smoke)
    if device.type == "cuda":
        return cfg.with_(use_flash_kernel=True, use_paged_kernel=True,
                         use_ssd_kernel=True)
    return cfg.with_(param_dtype="float32", compute_dtype="float32")


def _serve(args) -> dict:
    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device available")
    cfg = _device_config(args.arch, args.smoke, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = MD.init_model(cfg, gen)
    if args.continuous:
        return _serve_continuous(params, cfg, args, device)
    return _serve_static(params, cfg, args, device)


if __name__ == "__main__":
    from repro_torch.obs import log as _log
    _log.configure()  # CLI runs show progress; library use stays quiet
    serve()
