#!/usr/bin/env python3
"""A/B of two checkouts of the port on one card: phase 4's warm serve run
of `chip_smoke.py` and the paged and SSD kernels' host time a call.

    python3 tools/serve_ab.py ROOT_A ROOT_B [--order ABBA] [--runs 2]
                              [--arch qwen3-0.6b] [--out FILE]

Each letter of --order is one child process on the card that puts that
checkout's src/ first on sys.path (its repro_torch, its kernels built
from its own csrc/ into its own build/) and drives it with this
checkout's `chip_smoke.serve`: the warm-up batch and the timed run of
phase 4's 16 requests through a fresh paged engine, --runs times, launch
counts checked.  The child then times the eager `ops.paged_attention`
over every layer's pool, each a slice of one stacked tensor as a serve
tick calls it (8 slots on 40 pages of 16, the arch's heads): the host's
microseconds a call, the launches queued faster than the card runs them.
For an arch with Mamba2 layers (zamba2-1.2b) it then times the eager
`ops.ssd_scan` the same way over every layer's own fresh inputs at a
512-token prefill.  Both checkouts are built first, in parallel.  Prints
one JSON line a child and, last, one JSON object of every child's numbers
by checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ["flash_attention", "paged_attention", "nat_compress", "ssd_scan"]


def child(root: str, runs: int, arch: str) -> dict:
    sys.path.insert(0, HERE)                     # this checkout's chip_smoke
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD
    from repro_torch.serving import Request, ServeEngine
    assert os.path.dirname(MD.__file__).startswith(os.path.abspath(root))
    cfg = cs.kernel_cfg(arch)
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    out = []
    for _ in range(runs):
        _, _, launches, st, wall, _ = cs.serve(torch, cfg, params, ops,
                                               ServeEngine, Request)
        out.append({"tok_s": st["generated_tokens"] / wall, "wall_s": wall,
                    "decode_ticks": st["decode_ticks"],
                    "ms_a_tick": 1e3 * wall / (st["decode_ticks"]
                                               + st["prefill_ticks"]),
                    "launches": launches})
    del params
    torch.cuda.empty_cache()
    L, B, P, n_max = cfg.num_layers, 8, 16, 40
    Hq, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(1)
    k, v = (torch.randn(L, B * n_max + 1, P, Hk, dh, generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    q = torch.randn(B, Hq, dh, generator=g, device="cuda").bfloat16()
    bt = torch.randperm(B * n_max, generator=torch.Generator().manual_seed(2)
                        ).reshape(B, n_max).int().cuda()
    pos = torch.full((B,), n_max * P - 1, dtype=torch.int32, device="cuda")
    calls = []
    for rep in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(L):
            ops.paged_attention(q, k[i], v[i], bt, pos)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if rep:                                  # the first pass warms up
            calls.append(1e6 * (t1 - t0) / L)
    res = {"root": root, "runs": out, "paged_host_us_a_call": calls}
    del k, v
    if getattr(cfg, "ssm_heads", 0):
        S, H = 512, cfg.ssm_heads
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        layers = [cs.ssd_case(torch, 1, S, H, P, N, torch.bfloat16, seed=i)
                  for i in range(L)]
        ssd = []
        for rep in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for xe, loga, b, c in layers:
                ops.ssd_scan(xe, loga, b, c, chunk=cfg.ssm_chunk)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            if rep:
                ssd.append(1e6 * (t1 - t0) / L)
        res["ssd_host_us_a_call"] = ssd
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2, help="checkouts A and B")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--runs", type=int, default=2,
                    help="timed serve runs a child")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.runs, args.arch)))
        return 0
    roots = {"A": os.path.abspath(args.roots[0]),
             "B": os.path.abspath(args.roots[1])}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from repro_torch.kernels import build; build.build(sys.argv[2:])",
         os.path.join(r, "src"), *KERNELS]) for r in roots.values()]
    if any(p.wait() for p in builds):
        print("serve_ab: a build failed", file=sys.stderr)
        return 1
    res = {k: [] for k in roots}
    for letter in args.order:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), *args.roots,
             "--runs", str(args.runs), "--arch", args.arch,
             "--child", roots[letter]], capture_output=True, text=True)
        if run.returncode:
            print(f"serve_ab: child {letter} failed:\n{run.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        line = run.stdout.strip().splitlines()[-1]
        print(f"{letter}: {line}", flush=True)
        res[letter].append(json.loads(line))
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
