#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure, and then no result is printed):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `src/repro_torch/csrc` (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the card, in
     bf16 (2e-2) and fp32 (2e-5, TF32 off), at the serve path's shapes;
  4. serve qwen3-0.6b at full width (28 layers, bf16, seeded random
     weights) through the paged continuous-batching ServeEngine, with the
     kernel launch counters zeroed just before and read just after; then
     hold the kernel path's prefill logits and paged decode logits against
     the plain versions' (flags off);
  5. time each kernel beside its plain version, one PyTorch library call
     (timed only, never used by the port) and its bound; print tokens/s.

The serve run of phase 4 is timed warm: one short batch goes through the
same engine first (cuBLAS handles, allocator growth, first launches).
With `--profile`, phase 4 also serves the workload twice more: once with
a synchronize after every engine tick, which splits the wall time into
admits (prefill) and decode chunks, and once under `torch.profiler` over
a window of engine ticks, which gives kernel time by name and the card's
busy share (summed kernel time over the window's wall time).

Every line that holds a measured number names the card and its power
limit.  The second-last line is the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`.  With `--out DIR` the full results also
go to `DIR/chip_smoke.json`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor rate and
# HBM bandwidth; a bound is the larger of operations/rate and bytes/rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# tolerances: |kernel - plain| <= tol + tol * |plain|, elementwise
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# serve-path logits, kernel path vs plain path, bf16 through 28 layers:
# |diff| <= LOGIT_TOL * max(1, max|plain logit|)
LOGIT_TOL = 5e-2

ARCH = "qwen3-0.6b"
SLOTS, REQUESTS, PAGE = 8, 16, 16
PLEN, GEN = (256, 512), (32, 128)
WARMUP_GEN = 4                        # budget of the warm-up batch
WINDOW_SKIP, WINDOW_TICKS = 24, 12    # --profile: ticks before / inside


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def sdpa(q, k, v, **kw):
    """torch's scaled_dot_product_attention over GQA heads (q (B,Hq,S,dh),
    k/v (B,Hk,T,dh)): the library yardstick, timed only."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def max_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def check_close(name, out, ref, tol) -> float:
    import torch
    err = (out.float() - ref.float()).abs()
    lim = tol + tol * ref.float().abs()
    if not bool(torch.isfinite(out.float()).all()):
        fail(f"{name}: non-finite output")
    if bool((err > lim).any()):
        fail(f"{name}: max |err| {float(err.max())} beyond tol {tol}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def flash_cases():
    # main path: one request's prefill, Hq=16, Hk=8, dh=128, causal
    main = [(1, S, S, 16, 8, 128, True, None) for S in (200, 512, 1024)]
    return main, [(1, 512, 512, 16, 8, 128, True, 128)]


def paged_case(B, Np, P, n_max, Hq, Hk, dh, dtype, seed):
    """Scrambled page ids, disjoint across rows.  Returns the inputs with
    every page outside the rows' live prefixes poisoned with +-1e9, and
    the clean pools."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Hq, dh, generator=g, device="cuda").to(dtype)
    kp = torch.randn(Np, P, Hk, dh, generator=g, device="cuda").to(dtype)
    vp = torch.randn(Np, P, Hk, dh, generator=g, device="cuda").to(dtype)
    perm = torch.randperm(Np, generator=torch.Generator().manual_seed(seed))
    ids = perm[:B * n_max].reshape(B, n_max).to(torch.int32)
    pos = torch.randint(0, n_max * P, (B,),
                        generator=torch.Generator().manual_seed(seed + 1),
                        dtype=torch.int32)
    live = {int(ids[b, j]) for b in range(B)
            for j in range(int(pos[b]) // P + 1)}
    stale = torch.tensor([p for p in range(Np) if p not in live],
                         dtype=torch.long)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[stale.cuda()] = 1e9
    vp2[stale.cuda()] = -1e9
    return (q, kp2, vp2, ids.cuda(), pos.cuda()), (kp, vp)


def check_kernels(torch, FA, PA, rows):
    errs = {"flash_attention": 0.0, "paged_attention": 0.0}
    main, extra = flash_cases()
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for i, (B, S, T, Hq, Hk, dh, causal, window) in enumerate(main + extra):
            g = torch.Generator(device="cuda").manual_seed(i)
            q = torch.randn(B, S, Hq, dh, generator=g, device="cuda").to(dt)
            k = torch.randn(B, T, Hk, dh, generator=g, device="cuda").to(dt)
            v = torch.randn(B, T, Hk, dh, generator=g, device="cuda").to(dt)
            out = FA.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ref = FA.reference(q, k, v, causal=causal, window=window)
            e = check_close(f"flash {dtype} S={S} window={window}", out, ref,
                            TOL[dtype])
            rows.append(["flash_attention", dtype, (B, S, T, Hq, Hk, dh),
                         window, e])
            if dtype == "bfloat16" and i < len(main):
                errs["flash_attention"] = max(errs["flash_attention"], e)
        shapes = [(8, 400, 16, 40, 16, 8, 128),   # main path: 8 slots, P=16
                  (3, 16, 8, 4, 8, 2, 128), (2, 16, 4, 4, 4, 4, 128),
                  (1, 8, 16, 2, 8, 4, 128), (4, 32, 8, 8, 8, 8, 128)]
        for i, shp in enumerate(shapes):
            args, (kp, vp) = paged_case(*shp, dt, seed=10 + i)
            out = PA.paged_attention(*args)
            clean = PA.paged_attention(args[0], kp, vp, *args[3:])
            torch.cuda.synchronize()
            if not torch.equal(out, clean):
                fail(f"paged {dtype} {shp}: poisoned stale pages changed "
                     f"the output")
            ref = PA.reference(*args)
            e = check_close(f"paged {dtype} {shp}", out, ref, TOL[dtype])
            rows.append(["paged_attention", dtype, shp, None, e])
            if dtype == "bfloat16" and i == 0:
                errs["paged_attention"] = e
    return errs


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------
def make_requests(cfg, Request):
    import numpy as np
    rng = np.random.RandomState(0)
    return [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab_size,
                                       size=int(rng.randint(*PLEN) + 1)),
                    max_new_tokens=int(rng.randint(*GEN) + 1))
            for i in range(REQUESTS)]


def make_engine(cfg, params, ServeEngine):
    return ServeEngine(params, cfg, num_slots=SLOTS,
                       cache_len=PLEN[1] + GEN[1], page_size=PAGE,
                       device="cuda")


def serve(torch, cfg, params, ops, ServeEngine, Request):
    reqs = make_requests(cfg, Request)
    eng = make_engine(cfg, params, ServeEngine)
    # warm-up: one short batch over every slot, then a fresh pool
    eng.run([Request(rid=r.rid, prompt=r.prompt, max_new_tokens=WARMUP_GEN)
             for r in reqs[:SLOTS]])
    eng.reset()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    fins = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": ops.flash_attention.launches,
                "paged_attention": ops.paged_attention.launches}
    if len(fins) != len(reqs):
        fail(f"{len(fins)} of {len(reqs)} requests finished")
    for f, r in zip(fins, reqs):
        if f.rid != r.rid or len(f.tokens) != r.max_new_tokens:
            fail(f"request {r.rid}: {len(f.tokens)} tokens, budget "
                 f"{r.max_new_tokens}")
        if not all(0 <= t < cfg.vocab_size for t in f.tokens):
            fail(f"request {r.rid}: token out of the vocabulary")
    for name, n in launches.items():
        if n <= 0:
            fail(f"the serve run launched {name} {n} times")
    st = eng.stats()
    return reqs, launches, st, wall


def _device_us(row) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(row, name):
            return float(getattr(row, name))
    return 0.0


def profile_serve(torch, cfg, params, ServeEngine, Request):
    """--profile: the phase-4 workload split into admits and decode ticks
    (a synchronize after every tick), then a torch.profiler window."""
    def loaded():
        eng = make_engine(cfg, params, ServeEngine)
        for r in make_requests(cfg, Request):
            eng.submit(r)
        torch.cuda.synchronize()
        return eng

    eng = loaded()
    split = {"prefill": 0.0, "decode": 0.0}
    count = {"prefill": 0, "decode": 0}
    while not eng.scheduler.done:
        t0 = time.perf_counter()
        kind = eng.tick()
        torch.cuda.synchronize()
        split[kind] = split.get(kind, 0.0) + time.perf_counter() - t0
        count[kind] = count.get(kind, 0) + 1
    st = eng.stats()
    res = {"split": {
        "prefill_s": split["prefill"], "admits": count["prefill"],
        "decode_s": split["decode"], "decode_chunks": count["decode"],
        "decode_ticks": st["decode_ticks"],
        "ms_per_decode_tick": 1e3 * split["decode"] / st["decode_ticks"],
        "ms_per_admit": 1e3 * split["prefill"] / count["prefill"],
        "prefill_tokens": st["prefill_tokens"],
        "tokens": st["generated_tokens"],
        "tok_s": st["generated_tokens"] / (split["prefill"]
                                           + split["decode"])}}

    eng = loaded()
    for _ in range(WINDOW_SKIP):
        eng.tick()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    kinds = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(WINDOW_TICKS):
            kinds.append(eng.tick())
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    avg = prof.key_averages()
    kern = sorted(((r.key, _device_us(r), r.count) for r in avg
                   if str(getattr(r, "device_type", "")).endswith("CUDA")),
                  key=lambda x: -x[1])
    busy_us = sum(us for _, us, _ in kern)
    res["trace"] = {
        "ticks": kinds, "window_s": window_s, "kernel_s": busy_us / 1e6,
        "kernel_launches": sum(c for *_, c in kern),
        "cpu_ops": sum(r.count for r in avg
                       if str(getattr(r, "device_type", "")).endswith("CPU")),
        "busy_share": (busy_us / 1e6 / window_s) if busy_us else None,
        "top_kernels": [{"name": k, "ms": us / 1e3, "count": c}
                        for k, us, c in kern[:15]]}
    return res


def compare_plain_paths(torch, cfg, params, MD, reqs):
    """Prefill (flash) and one paged decode tick (paged kernel) with both
    flags on, against the same with both flags off."""
    plain = cfg.with_(use_flash_kernel=False, use_paged_kernel=False)
    res = {}
    prompts = [torch.as_tensor(r.prompt, device="cuda")[None].int()
               for r in reqs[:2]]
    lk, _, _ = MD.forward(params, cfg, prompts[0])
    lp, _, _ = MD.forward(params, plain, prompts[0])
    for name, a in (("kernel", lk), ("plain", lp)):
        if not bool(torch.isfinite(a.float()).all()):
            fail(f"prefill logits ({name} path) not finite")
    scale = max(1.0, float(lp[0, -1].float().abs().max()))
    err = max_err(lk[0, -1], lp[0, -1])
    if err > LOGIT_TOL * scale:
        fail(f"prefill last-position logits differ by {err} "
             f"(> {LOGIT_TOL} x {scale})")
    same = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    res["prefill"] = {"S": prompts[0].shape[1], "max_abs_err": err,
                      "logit_scale": scale, "greedy_same_share": same}

    # a paged pool holding both prompts on scrambled pages
    n_max = -(-(PLEN[1] + GEN[1]) // PAGE)
    Np = 2 * n_max
    pool = MD.init_paged_cache(cfg, 2, Np, PAGE, "cuda")
    ids = torch.randperm(Np, generator=torch.Generator().manual_seed(3)
                         ).reshape(2, n_max).int().cuda()
    toks, pos = [], []
    for b, p in enumerate(prompts):
        S = p.shape[1]
        npg = -(-(S + 1) // PAGE)
        lg, _, c = MD.forward(params, cfg, p, return_cache=True,
                              cache_len=npg * PAGE)
        MD.write_paged_cache(pool, c, b, ids[b, :npg], cfg)
        toks.append(int(lg[0, -1].argmax()))
        pos.append(S)
    tok = torch.tensor(toks, device="cuda", dtype=torch.int32)[:, None]
    pos = torch.tensor(pos, device="cuda", dtype=torch.int32)
    active = torch.ones(2, dtype=torch.bool, device="cuda")
    pool2 = {n: t.clone() for n, t in pool.items()}
    dk, _ = MD.decode_step(params, cfg, tok, pos, pool, active=active,
                           block_tables=ids, logical_len=n_max * PAGE)
    dp, _ = MD.decode_step(params, plain, tok, pos, pool2, active=active,
                           block_tables=ids, logical_len=n_max * PAGE)
    scale = max(1.0, float(dp.float().abs().max()))
    err = max_err(dk, dp)
    if err > LOGIT_TOL * scale:
        fail(f"paged decode logits differ by {err} "
             f"(> {LOGIT_TOL} x {scale})")
    same = float((dk.argmax(-1) == dp.argmax(-1)).float().mean())
    res["decode"] = {"B": 2, "max_abs_err": err, "logit_scale": scale,
                     "greedy_same_share": same}
    return res


# ---------------------------------------------------------------------------
# phase 5: times and bounds
# ---------------------------------------------------------------------------
def time_flash(torch, FA, S=512):
    B, Hq, Hk, dh = 1, 16, 8, 128
    g = torch.Generator(device="cuda").manual_seed(42)
    q = torch.randn(B, S, Hq, dh, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, S, Hk, dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, S, Hk, dh, generator=g, device="cuda").bfloat16()
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: FA.reference(q, k, v), n=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    pairs = S * (S + 1) // 2                      # causal (query, key) pairs
    flops = 4 * B * Hq * dh * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, k, v, out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"shape": [B, S, Hq, Hk, dh], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library": "scaled_dot_product_attention",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def time_paged(torch, PA, pos_list):
    B, Hq, Hk, dh, P = len(pos_list), 16, 8, 128, PAGE
    n_max = -(-(PLEN[1] + GEN[1]) // P)
    Np = B * n_max
    g = torch.Generator(device="cuda").manual_seed(43)
    q = torch.randn(B, Hq, dh, generator=g, device="cuda").bfloat16()
    kp = torch.randn(Np + 1, P, Hk, dh, generator=g, device="cuda").bfloat16()
    vp = torch.randn(Np + 1, P, Hk, dh, generator=g, device="cuda").bfloat16()
    bt = torch.randperm(Np, generator=torch.Generator().manual_seed(4)
                        ).reshape(B, n_max).int().cuda()
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: PA.paged_attention(q, kp, vp, bt, pos), n=50)
    plain_ms = cuda_ms(lambda: PA.reference(q, kp, vp, bt, pos), n=10)
    C = n_max * P
    valid = (torch.arange(C, device="cuda")[None] <= pos[:, None].long())
    mask = valid[:, None, None, :]                 # (B,1,1,C)
    qs = q[:, :, None, :]                          # (B,Hq,1,dh)

    def library():
        kg = kp[bt.long()].reshape(B, C, Hk, dh).transpose(1, 2)
        vg = vp[bt.long()].reshape(B, C, Hk, dh).transpose(1, 2)
        return sdpa(qs, kg, vg, attn_mask=mask)
    lib_ms = cuda_ms(library, n=50)
    resident = sum(p + 1 for p in pos_list)        # positions attended
    nbytes = (2 * resident * Hk * dh * 2           # K and V, bf16
              + 2 * 2 * q.numel()                  # q and out
              + 4 * (bt.numel() + B))              # block tables and pos
    flops = 4 * Hq * dh * resident
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"shape": [B, Hq, Hk, dh, P, n_max], "pos": pos_list, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "gather + scaled_dot_product_attention",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the full results, chip_smoke.json")
    ap.add_argument("--profile", action="store_true",
                    help="also split a serve run into admits and decode "
                         "ticks and trace a window of it")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch next to {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    # numerics: fp32 products in full fp32, bf16 GEMMs reduce in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import model as MD
    from repro_torch.models.config import param_count
    from repro_torch.serving import Request, ServeEngine

    t_start = time.perf_counter()
    card = card_line()                                          # phase 1
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()                                    # phase 2
    reports = build.build(["flash_attention", "paged_attention"])
    build_s = time.perf_counter() - t0
    print(f"build [{card}]: {build_s:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    rows = []                                                   # phase 3
    errs = check_kernels(torch, FA, PA, rows)
    for r in rows:
        print(f"check [{card}] {r[0]} {r[1]} {r[2]} window={r[3]} "
              f"max|err|={r[4]:.3g}")

    cfg = get_config(ARCH).with_(use_flash_kernel=True,         # phase 4
                                 use_paged_kernel=True)
    total, _ = param_count(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = MD.init_model(cfg, gen)
    reqs, launches, st, wall = serve(torch, cfg, params, ops, ServeEngine,
                                     Request)
    tps = st["generated_tokens"] / wall
    print(f"serve [{card}]: {ARCH} {total / 1e6:.1f}M params bf16, "
          f"{SLOTS} slots, {REQUESTS} requests, warm run: "
          f"{st['generated_tokens']} tokens in {wall:.2f} s = "
          f"{tps:.1f} tok/s, "
          f"prefill_tokens={st['prefill_tokens']} "
          f"decode_ticks={st['decode_ticks']} "
          f"pool_occupancy={st['pool_occupancy']:.3f} "
          f"preemptions={st['preemptions']} launches={launches}")
    prof = None
    if args.profile:
        prof = profile_serve(torch, cfg, params, ServeEngine, Request)
        print(f"split [{card}]: {json.dumps(prof['split'])}")
        print(f"trace [{card}]: "
              f"{json.dumps(dict(prof['trace'], top_kernels=None))}")
        for k in prof["trace"]["top_kernels"]:
            print(f"  kernel [{card}] {k['ms']:.3f} ms x{k['count']} "
                  f"{k['name'][:100]}")
    plain = compare_plain_paths(torch, cfg, params, MD, reqs)
    print(f"kernel vs plain path [{card}]: {json.dumps(plain)}")

    flash_t = time_flash(torch, FA)                             # phase 5
    mid = [PLEN[0] + (PLEN[1] + GEN[1] - PLEN[0]) * i // SLOTS
           for i in range(SLOTS)]
    paged_t = time_paged(torch, PA, mid)
    for name, t in (("flash_attention", flash_t),
                    ("paged_attention", paged_t)):
        print(f"time [{card}] {name} {t['shape']}: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, {t['library']} "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")

    kernels = []
    for name, t, replaces in (
            ("flash_attention", flash_t,
             "src/repro/kernels/flash_attention.py:77"),
            ("paged_attention", paged_t,
             "src/repro/kernels/paged_attention.py:77")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    elapsed = time.perf_counter() - t_start
    result = {"card": card, "build_s": build_s, "elapsed_s": elapsed,
              "checks": rows, "serve": dict(st, wall_s=wall, tok_s=tps,
                                            launches=launches),
              "profile": prof, "plain_paths": plain,
              "timing": {"flash_attention": flash_t,
                         "paged_attention": paged_t}}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump(result, fh, indent=1, default=str)
    print(f"elapsed [{card}]: {elapsed:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
