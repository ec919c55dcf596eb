#!/usr/bin/env python3
"""A/B of the SSD scan's card time in two checkouts of the port, on one
card.

    python3 tools/ssd_ab.py ROOT_A ROOT_B [--order ABBA]

Each letter of --order is one child process that puts that checkout's
src/ first on sys.path (its kernels built from its own csrc/) and times
its `kernels.ssd_scan.ssd_scan` with `chip_smoke.device_ms` (CUDA-graph
replays; this checkout's chip_smoke) at zamba2-1.2b's prefills of 512,
384 and 256 tokens and at 2048 (B 1, H 64, P = N = 64, chunk 128, bf16; the
inputs of `chip_smoke.time_ssd`).  Each child also runs 20 eager calls a
shape under `torch.profiler` and reports each of the checkout's kernels'
device microseconds a call (`us_by_kernel`), to show which kernel of a
call holds its time.  Prints one JSON line a child and, last, every
child's numbers by checkout and shape.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1, 512, 64, 64, 64, 128), (1, 384, 64, 64, 64, 128),
          (1, 256, 64, 64, 64, 128), (1, 2048, 64, 64, 64, 128)]


def child(root: str) -> dict:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan as SS
    assert os.path.dirname(SS.__file__).startswith(os.path.abspath(root))
    out, by_kernel = {}, {}
    for B, S, H, P, N, Q in SHAPES:
        xe, loga, b, c = cs.ssd_case(torch, B, S, H, P, N, torch.bfloat16,
                                     seed=45)

        def call():
            return SS.ssd_scan(xe, loga, b, c, chunk=Q)
        out[f"S={S}"] = min(cs.device_ms(call, n=50) for _ in range(3))
        by_kernel[f"S={S}"] = kernel_us(torch, cs, call)
    return {"root": root, "ms": out, "us_by_kernel": by_kernel}


def kernel_us(torch, cs, call, n=20):
    """Each port kernel's device microseconds a call over n eager calls
    under torch.profiler, by the kernel's name up to its arguments."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    us = {}
    for k in cs.trace_summary(prof, 1.0)["port_kernels"]:
        bare = re.sub(r"^void\s+|\(anonymous namespace\)::", "", k["name"])
        m = re.search(r"(\w+)\s*[<(]", bare)
        name = m.group(1) if m else k["name"]
        us[name] = us.get(name, 0.0) + 1e3 * k["ms"] / n
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2, help="checkouts A and B")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    roots = {"A": os.path.abspath(args.roots[0]),
             "B": os.path.abspath(args.roots[1])}
    res = {k: [] for k in roots}
    for letter in args.order:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), *args.roots,
             "--child", roots[letter]], capture_output=True, text=True)
        if run.returncode:
            print(f"ssd_ab: child {letter} failed:\n{run.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        line = run.stdout.strip().splitlines()[-1]
        print(f"{letter}: {line}", flush=True)
        res[letter].append(json.loads(line))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
