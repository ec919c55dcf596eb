#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure, and then no result is printed):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `src/repro_torch/csrc` (nvcc, sm_90a),
     one nvcc per source, all started together;
  3. hold each kernel against its plain PyTorch version on the card: the
     attention kernels in bf16 (2e-2) and fp32 (2e-5, TF32 off) at both
     serve paths' shapes (qwen3-0.6b: dh 128, 16/8 heads; zamba2-1.2b:
     dh 64, 32/32 heads), at the flash kernel's 64-row / 64-key tile
     edges, S < T, windows and full masking, and the paged kernel with
     positions at the edges of its planned splits (and a row at pos -1,
     which must emit 0), every group and page size, stale pages poisoned
     (the output must not change by a bit) and each call twice (the two
     outputs must be bit-identical), and at the verify shape (8 table rows,
     each repeated for 4 candidate rows); both attention kernels at
     phase 4c's shapes (flash at a 512-token prompt, paged at 8 slots on
     321 pages: qwen3-moe 32/4 heads of 128, G 8; deepseek-7b 32/32, G 1;
     arctic-480b 56/8, G 7), and the paged kernel's split edges at G 7;
     both at phase 4d's shapes (flash: whisper-tiny's encoder, S = T =
     1500 non-causal, and its cross-attention prefill, 320 x 1500;
     phi-3-vision's 576 patches + 512 tokens at dh 96; nemotron-4-340b's
     512 tokens at dh 192, G 12; the -swa prefill of 6144 tokens with
     window 4096; paged: each model's pool at 8 slots), and the split
     edges at dh 96, dh 192 and G 12;
     the SSD scan in fp32 and bf16 (1e-4: both
     compute in fp32) at the JAX package's test shapes and zamba2's
     prefill, a prompt shorter than the chunk, ragged last chunks (S 500,
     130, 17), strong decay at S 512 and 500 that must stay finite and
     hold to the float64 recurrence, the sequential oracle, and two
     identical calls bit-identical; nc_pack /
     nc_unpack bit for bit, fp32 and bf16, on ragged sizes with zeros,
     powers of two and their predecessors and values outside the wire's
     range [2^-69, 2^57);
  4. serve qwen3-0.6b at full width (28 layers, bf16, seeded random
     weights) through the paged continuous-batching ServeEngine, with the
     kernel launch counters zeroed just before and read just after (28
     flash launches an admit, 28 paged launches a decode tick); then hold
     the kernel path's prefill logits and paged decode logits against the
     plain versions' (flags off); then serve zamba2-1.2b at full width
     (38 Mamba2 layers, the shared attention block after every 6th, bf16)
     the same way, the same prompt lengths (ragged last chunks): 38
     ssd_scan and 6 flash launches an admit, 6 paged launches a decode
     tick, no preemption; the kernel path's logits against the plain
     path's, and the kernel's y and final state at every Mamba2 layer on
     the very inputs of the plain path's scan (1e-4 of the largest
     entry); then the same requests through a second zamba2 engine with
     half the pages 8 slots need at full length: at least one
     preemption, a re-admit whose prefill is not a whole number of
     chunks, every request finished with its full budget, the launch
     counts exact;
  4b. serve qwen3-1.7b at full width (28 layers, d_model 2048, bf16) on
     the same stream three times: the plain paged engine, the
     speculative engine with the n-gram lookup draft (k 3), and with
     qwen3-0.6b drafting (k 3, its weights from another seed); launch
     counts exact (an admit: 28 flash, and 28 more for the model draft's
     prefill; a verify round: 28 paged; the draft's dense decode scan:
     none), every emitted token a near-argmax of a teacher-forced plain
     forward of the target over prompt + emitted (within 5e-2 x max(1,
     max|logit|) of its row's maximum); the share of tokens equal to the
     plain run's reported, not gated; then qwen3-0.6b drafting for itself
     on 4 requests, with at least one round that accepts all k.  Then
     qwen3-0.6b and zamba2-1.2b each serve phase 4's stream, drained after
     11 ticks, the requests re-admitted through ServingDrainReadmit onto
     a second engine: every harvested page and row read back bit-equal
     after its install, migrated_admits equal to the harvested count, no
     prefill of a harvested prefix, every request at its full budget,
     launch counts exact (no flash, no ssd_scan for a migrated admit);
  4c. serve phase 4's stream with qwen3-moe-30b-a3b (48 layers, d_model
     2048, 128 experts of 768 top-8, bf16: 61.1 GB), deepseek-7b (30
     layers, d_model 4096, G 1: 13.8 GB) and arctic-480b at its published
     widths with its depth cut from 35 to 2 layers (d_model 7168, G 7,
     128 experts of 4864 top-2 and the dense residual: 55.4 GB), one
     after another, each one's params freed before the next is drawn:
     launch counts exact (an admit: one flash a layer; a decode tick: one
     paged a layer), every request at its full budget; tokens/s, ticks,
     occupancy, peak device memory, ms a decode tick (a synchronize after
     every admit and decode chunk) beside its bytes bound; the kernel
     path against the plain path on one admit and one decode tick; for
     the MoE models the (token, layer) expert choices that differ between
     the paths (bf16 router near-ties flip) are counted and reported, and
     the logits of every prefill position and decode row are held against
     the plain path run with the kernel path's expert choices; at the
     first layer, where both paths see the same input, the flash output
     is held to the bf16 tolerance and every flipped token must be a
     near-tie that its router probabilities' measured change crosses;
     the plain path with SDPA attention is a control whose flips are
     reported beside the kernel path's;
  4d. the last families, as 4c: rwkv6-1.6b (24 layers, d_model 2048:
     2.97 GB; the dense engine, no kernel; its gate the prefill's
     recurrent state and last logits against the same prompt fed token
     by token), whisper-tiny (4 + 4 layers over 1500 frames a request
     drawn from a seed, its stream cut to the 448-token decoder: prompts
     64-320; launches exact: 12 flash an admit, 4 encoder, 4 self, 4
     cross, and 4 paged a tick), phi-3-vision-4.2b (32 layers, dh 96,
     576 patches a request drawn from a seed, cache 640 + 576: 7.64 GB)
     and nemotron-4-340b at its published widths cut from 96 to 4 layers
     (d_model 18432, 96/8 heads of 192, G 12, d_ff 73728: 46.5 GB);
     then qwen3-0.6b-swa (window 4096): a 6144-token prompt prefilled
     through flash, the ring of 4096 slots built from its cache, 64
     decode steps on the ring, each step's logits held against the plain
     path's windowed forward of all 6208 tokens;
  5. time each kernel beside its plain version, one PyTorch library call
     where one computes the same function (timed only, never used by the
     port) and its bound, the attention kernels at both serve paths'
     shapes, and the paged kernel at the verify shape (8 slots x 4
     candidate rows of qwen3-1.7b), both attention kernels also at phase
     4c's three head layouts and 4d's (whisper's encoder and a 192-token
     cross read, phi-3's 1088-token prefill, nemotron's dh 192 at G 12;
     paged at each model's pool): card time from CUDA-graph replays
     (`device_ms`: these kernels take less time than the host needs to
     issue them), and the eager call time beside it;
  6. train qwen3-0.6b at full width (28 layers, bf16, block remat, AdamW,
     warmup-cosine, natural-compressed gradients, the synthetic bigram
     pipeline) at batch 2 x seq 4096: one warm-up step, then timed steps
     with the launch counters zeroed just before and read just after
     (14 nc_pack and 14 nc_unpack launches a step, one per gradient leaf;
     no attention kernel); then one step's split into forward+backward,
     compression and optimizer, and the same gradients compressed by the
     kernels and by the plain versions, which must agree bit for bit, and
     so must the parameters each update gives.

The serve runs of phase 4 are timed warm: one short batch goes through
the same engine first (cuBLAS handles, allocator growth, first launches).
With `--profile`, phase 4 also serves each workload twice more: once with
a synchronize after every engine tick, which splits the wall time into
admits (prefill) and decode chunks, and once under `torch.profiler` over
a window of engine ticks, which gives kernel time by name and the card's
busy share (summed kernel time over the window's wall time); phase 6
runs one more train step under `torch.profiler`.

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
# the SSD scan computes in fp32 from either input type, as its plain
# version does: the JAX package's own kernel-test figure, for both
SSD_TOL = 1e-4
# serve-path logits, kernel path vs plain path, bf16 through 28 layers:
# |diff| <= LOGIT_TOL * max(1, max|plain logit|)
LOGIT_TOL = 5e-2
# rwkv6's recurrent state after a prompt, prefill vs token by token
# through all 24 layers, of each layer's largest entry (rwkv_state_check)
RWKV_PATH_TOL = 1e-1

ARCH = "qwen3-0.6b"
HYBRID = "zamba2-1.2b"
# phase 4b: qwen3-0.6b drafting for qwen3-1.7b (the JAX package's zoo
# pairing), the draft's weights from another seed
TARGET, DRAFT_SEED, SPEC_K = "qwen3-1.7b", 7, 3
SELF_DRAFT_REQUESTS = 4
# drain after 8 admits and 3 decode chunks: every slot has emitted
DRAIN_TICKS = 11
SLOTS, REQUESTS, PAGE = 8, 16, 16
PLEN, GEN = (256, 512), (32, 128)
# zamba2's tight pool: half the pages of 8 slots at full length (40 each)
TIGHT_PAGES = 160
# phase 4c: the MoE family and the last dense config of one card, one
# after another on phase 4's stream, at full width; arctic-480b's 476.9B
# params do not fit one card, so its depth is cut (35 -> 2 layers)
MOE, DENSE7B, ARCTIC = "qwen3-moe-30b-a3b", "deepseek-7b", "arctic-480b"
FAMILY = ((MOE, None), (DENSE7B, None), (ARCTIC, 2))
# phase 4d: the last families the same way; nemotron-4-340b's 341.0B
# params do not fit one card, so its depth is cut (96 -> 4 layers)
RWKV, WHISPER, VLM, NEMOTRON = ("rwkv6-1.6b", "whisper-tiny",
                                "phi-3-vision-4.2b", "nemotron-4-340b")
LAST = ((RWKV, None), (WHISPER, None), (VLM, None), (NEMOTRON, 4))
# whisper's decoder context is 448 tokens (the shape plan's docstring):
# its prompts 64-320, budgets as phase 4's
WHISPER_PLEN = (63, 320)
# the -swa variant of qwen3-0.6b (shape_plan's long_500k, window 4096):
# one prompt past the window, then decode steps on the ring
SWA_PROMPT, SWA_STEPS = 6144, 64

WARMUP_GEN = 4                        # budget of the warm-up batch
# --profile: engine ticks before / inside the traced window
WINDOW = {ARCH: (24, 12), HYBRID: (24, 6), MOE: (24, 4), DENSE7B: (24, 6),
          ARCTIC: (24, 6), RWKV: (24, 6), WHISPER: (24, 12), VLM: (24, 6),
          NEMOTRON: (24, 6)}
# train phase: train_4k's sequence length, its global batch of 256 cut to
# 2 sequences on one card; one warm-up step, then TRAIN_STEPS timed
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 2, 4096, 10, 20
# the nc wire format: code 1..127 <=> |value| 2^-69 .. 2^57
NC_LO, NC_HI = 2.0 ** -69, 2.0 ** 57


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def kernel_of(line: str) -> str:
    """A kernel's name and template arguments, as mangled, from ptxas's
    'Compiling entry function' line."""
    i = line.find("_kernel")
    if i < 0:
        return line.strip()[:60]
    j = i
    while j > 0 and not line[j - 1].isdigit():
        j -= 1
    end = line.find("EEv", i)
    return line[j:end + 1] if end > 0 else line[j:i + 7]


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


def device_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Card time of one call of fn with the host out of the way: n calls
    captured in one CUDA graph, the graph replayed `reps` times between
    CUDA events.  A call whose kernels take less time than the host needs
    to issue them (the attention kernels at decode and prefill sizes)
    leaves the card idle between eager calls, and events around
    back-to-back eager calls then time the host: `cuda_ms` gives that call
    time beside it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / (reps * n)


def sdpa(q, k, v, **kw):
    """torch's scaled_dot_product_attention over GQA heads (q (B,Hq,S,dh),
    k/v (B,Hk,T,dh)): the library yardstick, timed only."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def max_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def bits(torch, t):
    """t's bits as integers: equal bits, not equal values (-0.0 != 0.0)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


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
    """(qwen3 main, zamba2 main, extra) shapes (B, S, T, Hq, Hk, dh,
    causal, window).  Main paths: one request's prefill, causal;
    qwen3-0.6b Hq=16, Hk=8, dh=128; zamba2-1.2b's shared block Hq=Hk=32
    (G 1), dh=64.  Extra: a window, and the bf16 kernel's 64-row / 64-key
    tile edges, S < T, full masking, every head dim and group.  Phase
    4c's main paths are in FAMILY_FLASH."""
    qwen = [(1, S, S, 16, 8, 128, True, None) for S in (200, 512, 1024)]
    zamba = [(1, S, S, 32, 32, 64, True, None) for S in (128, 512)]
    extra = [(1, 512, 512, 16, 8, 128, True, 128),
             (1, 1, 64, 4, 4, 64, True, None),
             (1, 63, 63, 8, 4, 128, True, None),
             (1, 64, 64, 8, 2, 64, True, None),
             (1, 65, 65, 4, 4, 32, True, None),
             (2, 129, 129, 8, 2, 128, True, None),
             (1, 65, 200, 8, 4, 64, True, None),
             (1, 129, 129, 8, 2, 32, True, 40),
             (1, 100, 192, 8, 8, 128, True, 64),
             (1, 64, 256, 4, 2, 128, False, None),
             (2, 33, 64, 4, 1, 64, False, None),
             (1, 65, 130, 14, 2, 64, True, None)]        # G 7, S < T
    return qwen, zamba, extra


# phase 4c's prefill and decode shapes: the flash kernel at a 512-token
# prompt, the paged kernel at 8 slots on 321 pages (the qwen3 case's
# positions: the same seed, table width and page size)
FAMILY_FLASH = {MOE: (1, 512, 512, 32, 4, 128, True, None),
                DENSE7B: (1, 512, 512, 32, 32, 128, True, None),
                ARCTIC: (1, 512, 512, 56, 8, 128, True, None)}
FAMILY_PAGED = {MOE: (8, 321, 16, 40, 32, 4, 128),
                DENSE7B: (8, 321, 16, 40, 32, 32, 128),
                ARCTIC: (8, 321, 16, 40, 56, 8, 128)}
# phase 4d's, by kernel row: whisper's encoder (1500 frames, full
# attention, a ragged last tile) and its cross-attention prefill at the
# longest prompt (S != T, non-causal), phi-3's 576 patches + 512 tokens
# (dh 96), nemotron's dh 192 at G 12; the paged kernel at 8 slots on
# each model's pool (whisper 28 pages a slot, phi-3 76); the -swa
# prefill is held too (window 4096), but has no row of its own
LAST_FLASH = {WHISPER: (1, 1500, 1500, 6, 6, 64, False, None),
              f"{WHISPER}:cross": (1, 320, 1500, 6, 6, 64, False, None),
              VLM: (1, 1088, 1088, 32, 32, 96, True, None),
              NEMOTRON: (1, 512, 512, 96, 8, 192, True, None),
              "swa": (1, SWA_PROMPT, SWA_PROMPT, 16, 8, 128, True, 4096)}
LAST_PAGED = {WHISPER: (8, 8 * 28 + 1, 16, 28, 6, 6, 64),
              VLM: (8, 8 * 76 + 1, 16, 76, 32, 32, 96),
              NEMOTRON: (8, 321, 16, 40, 96, 8, 192)}


def paged_case(B, Np, P, n_max, Hq, Hk, dh, dtype, seed, pos=None):
    """Scrambled page ids, disjoint across rows, positions drawn at random
    unless given.  Returns the inputs with every page outside the rows'
    live prefixes poisoned with +-1e9, and the clean pools."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Hq, dh, generator=g, device="cuda").to(dtype)
    kp = torch.randn(Np, P, Hk, dh, generator=g, device="cuda").to(dtype)
    vp = torch.randn(Np, P, Hk, dh, generator=g, device="cuda").to(dtype)
    perm = torch.randperm(Np, generator=torch.Generator().manual_seed(seed))
    ids = perm[:B * n_max].reshape(B, n_max).to(torch.int32)
    if pos is None:
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


def verify_paged_case(PA, dtype, seed, slots=SLOTS, S=SPEC_K + 1, P=PAGE,
                      n_max=40, heads=(16, 8, 128)):
    """The paged kernel as attention_verify launches it: `slots` table
    rows on scrambled disjoint pages, each repeated for its S candidate
    rows at positions pos[b] + i, the slots' positions at the edges of
    the splits planned for slots * S rows; pages outside the live
    prefixes poisoned.  Returns the inputs and the clean pools."""
    import torch
    Hq, Hk, dh = heads
    _, span = PA.plan_splits(slots * S, Hk, n_max, P)
    w, last = span * P, n_max * P - S
    base = [0, w - 3, w - 1, w, w + 1, last, 100, last // 2][:slots]
    args, pools = paged_case(slots, slots * n_max + 1, P, n_max, Hq, Hk, dh,
                             dtype, seed, pos=torch.tensor(
                                 [p + S - 1 for p in base], dtype=torch.int32))
    q, kp, vp, bt, _ = args
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    qv = torch.randn(slots * S, Hq, dh, generator=g, device="cuda").to(dtype)
    pos = (torch.tensor(base, dtype=torch.int32, device="cuda")[:, None]
           + torch.arange(S, dtype=torch.int32, device="cuda")).reshape(-1)
    return (qv, kp, vp, bt.repeat_interleave(S, dim=0), pos), pools


def split_positions(PA, B, Hk, n_max, P):
    """Positions at the edges of the planned splits: 0, span-1, span,
    span+1 (in positions), the last position, -1 (no key), and two more."""
    _, span = PA.plan_splits(B, Hk, n_max, P)
    w, last = span * P, n_max * P - 1
    edges = [0, w - 1, w, w + 1, last, -1, last // 3, 2 * w + 1]
    if B == 1:
        return [last]
    return [min(last, edges[b % len(edges)]) for b in range(B)]


def check_paged(torch, PA, name, args, clean_pools, tol):
    """Poisoned stale pages invisible bit for bit, a second call
    bit-identical, rows at pos -1 zero, the rest within tol of plain."""
    out = PA.paged_attention(*args)
    again = PA.paged_attention(*args)
    clean = PA.paged_attention(args[0], *clean_pools, *args[3:])
    torch.cuda.synchronize()
    if not torch.equal(out, clean):
        fail(f"{name}: poisoned stale pages changed the output")
    if not torch.equal(out, again):
        fail(f"{name}: two identical calls differ")
    dead = args[4] < 0
    if not bool((out[dead] == 0).all()):
        fail(f"{name}: a row with no key did not emit 0")
    ref = PA.reference(*args)
    return check_close(name, out[~dead], ref[~dead], tol)


def check_kernels(torch, FA, PA, rows):
    errs = {"flash_attention": 0.0, f"flash_attention@{HYBRID}": 0.0,
            "paged_attention": 0.0, f"paged_attention@{HYBRID}": 0.0}
    qwen, zamba, extra = flash_cases()
    family = list(FAMILY_FLASH.values()) + list(LAST_FLASH.values())
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for i, (B, S, T, Hq, Hk, dh, causal, window) in enumerate(
                qwen + zamba + extra + family):
            g = torch.Generator(device="cuda").manual_seed(i)
            q = torch.randn(B, S, Hq, dh, generator=g, device="cuda").to(dt)
            k = torch.randn(B, T, Hk, dh, generator=g, device="cuda").to(dt)
            v = torch.randn(B, T, Hk, dh, generator=g, device="cuda").to(dt)
            out = FA.flash_attention(q, k, v, causal=causal, window=window)
            again = FA.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            name = (f"flash {dtype} {(B, S, T, Hq, Hk, dh)} causal={causal} "
                    f"window={window}")
            if not torch.equal(out, again):
                fail(f"{name}: two identical calls differ")
            ref = FA.reference(q, k, v, causal=causal, window=window)
            e = check_close(name, out, ref, TOL[dtype])
            rows.append(["flash_attention", dtype, (B, S, T, Hq, Hk, dh),
                         f"causal={causal} window={window}", e])
            if dtype == "bfloat16" and i < len(qwen) + len(zamba):
                key = ("flash_attention" if i < len(qwen)
                       else f"flash_attention@{HYBRID}")
                errs[key] = max(errs[key], e)
            for arch, shp in (*FAMILY_FLASH.items(), *LAST_FLASH.items()):
                if dtype == "bfloat16" and (B, S, T, Hq, Hk, dh, causal,
                                            window) == shp:
                    errs[f"flash_attention@{arch}"] = e
        # main paths first (8 slots, P=16; qwen3-0.6b, then zamba2-1.2b),
        # random positions, then positions at the split edges over every
        # group and page size the path may see
        shapes = [(8, 400, 16, 40, 16, 8, 128), (8, 320, 16, 40, 32, 32, 64),
                  (3, 16, 8, 4, 8, 2, 128), (2, 16, 4, 4, 4, 4, 128),
                  (1, 8, 16, 2, 8, 4, 128), (4, 32, 8, 8, 8, 8, 128)]
        edge = [(8, 16, 40, 16, 8, 128), (8, 16, 40, 32, 32, 64),
                (4, 16, 4, 4, 4, 128), (2, 8, 64, 8, 1, 64),
                (3, 32, 12, 8, 2, 32), (1, 16, 300, 2, 2, 64),
                (6, 8, 20, 4, 2, 128), (8, 16, 40, 56, 8, 128),
                (3, 8, 24, 7, 1, 32), (8, 16, 76, 32, 32, 96),
                (8, 16, 40, 96, 8, 192), (3, 8, 24, 12, 1, 96),
                (8, 16, 28, 6, 6, 64)]
        cases = [(shp, None) for shp in shapes]
        for B, P, n_max, Hq, Hk, dh in edge:
            cases.append(((B, B * n_max + 4, P, n_max, Hq, Hk, dh),
                          torch.tensor(split_positions(PA, B, Hk, n_max, P),
                                       dtype=torch.int32)))
        for i, (shp, pos) in enumerate(cases):
            args, pools = paged_case(*shp, dt, seed=10 + i, pos=pos)
            n_splits, _ = PA.plan_splits(shp[0], shp[5], shp[3], shp[2])
            e = check_paged(torch, PA, f"paged {dtype} {shp} splits="
                            f"{n_splits} pos={args[4].tolist()}", args,
                            pools, TOL[dtype])
            rows.append(["paged_attention", dtype, shp,
                         f"splits={n_splits}", e])
            if dtype == "bfloat16" and i < 2:
                key = ("paged_attention" if i == 0
                       else f"paged_attention@{HYBRID}")
                errs[key] = max(errs[key], e)
        # phase 4c's and 4d's decode shapes, at random positions
        for arch, shp in (*FAMILY_PAGED.items(), *LAST_PAGED.items()):
            args, pools = paged_case(*shp, dt, seed=10)
            n_splits, _ = PA.plan_splits(shp[0], shp[5], shp[3], shp[2])
            e = check_paged(torch, PA, f"paged {dtype} {shp} ({arch}) "
                            f"splits={n_splits} pos={args[4].tolist()}",
                            args, pools, TOL[dtype])
            rows.append(["paged_attention", dtype, shp,
                         f"{arch}, splits={n_splits}", e])
            if dtype == "bfloat16":
                errs[f"paged_attention@{arch}"] = e
        # the verify shape: 8 slots x S 4 candidate rows (qwen3-1.7b)
        args, pools = verify_paged_case(PA, dt, seed=30)
        n_splits, _ = PA.plan_splits(args[0].shape[0], 8, 40, PAGE)
        e = check_paged(torch, PA, f"paged verify {dtype} splits={n_splits} "
                        f"pos={args[4].tolist()}", args, pools, TOL[dtype])
        rows.append(["paged_attention", dtype, tuple(args[0].shape),
                     f"verify, {SLOTS} slots x S {SPEC_K + 1}, "
                     f"splits={n_splits}", e])
        if dtype == "bfloat16":
            errs["paged_attention@verify"] = e
    return errs


def ssd_case(torch, B, S, H, P, N, dtype, seed, decay=0.1):
    """xe, b, c in `dtype`; loga = -|normal| * decay - shift in float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xe = torch.randn(B, S, H, P, generator=g, device="cuda").to(dtype)
    loga = -torch.randn(B, S, H, generator=g, device="cuda").abs() * decay
    b = torch.randn(B, S, N, generator=g, device="cuda").to(dtype)
    c = torch.randn(B, S, N, generator=g, device="cuda").to(dtype)
    return xe, loga, b, c


def ssd_f64(xe, loga, b, c):
    """The SSD recurrence step by step in float64 (the exact answer to
    ~1e-12, for the strong-decay case)."""
    import torch
    xe, loga, b, c = xe.double(), loga.double(), b.double(), c.double()
    state = torch.zeros(xe.shape[0], xe.shape[2], b.shape[-1], xe.shape[3],
                        dtype=torch.float64, device=xe.device)
    ys = []
    for t in range(xe.shape[1]):
        state = (state * loga[:, t].exp()[..., None, None]
                 + torch.einsum("bn,bhp->bhnp", b[:, t], xe[:, t]))
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t], state))
    return torch.stack(ys, 1), state


def check_ssd(torch, SS, TR, rows):
    """The SSD scan against its plain version: the JAX package's test
    shapes, zamba2-1.2b's prefill (first), a prompt shorter than the
    chunk, SMOKE's chunk, ragged last chunks, P = N = 128 at chunk 256
    (fp32 inputs take tiles of 32 there); a strong decay (loga ~ -0.8
    a step, as zamba2's random weights give: L reaches ~-120 in a chunk)
    at S 512 and 500 that must stay finite and hold to the plain version
    and to the float64 recurrence; the sequential oracle at a small
    shape; and every call made twice, the two bit-identical."""
    shapes = [(1, 512, 64, 64, 64, 128),            # zamba2-1.2b prefill
              (2, 256, 4, 64, 64, 128), (1, 128, 2, 32, 16, 64),
              (2, 512, 3, 64, 64, 128), (1, 256, 1, 128, 32, 256),
              (1, 384, 2, 64, 64, 128), (2, 40, 4, 16, 128, 128),
              (1, 96, 4, 64, 64, 32),
              (1, 500, 64, 64, 64, 128),            # ragged last chunks
              (2, 130, 4, 64, 64, 128), (1, 17, 2, 16, 16, 32),
              (1, 300, 2, 128, 128, 256)]   # fp32: the kernel tiles by 32

    def scan_twice(name, *args, chunk):
        y, fin = SS.ssd_scan(*args, chunk=chunk)
        y2, fin2 = SS.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(fin, fin2)):
            fail(f"{name}: two identical calls differ")
        return y, fin

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, S, H, P, N, chunk) in enumerate(shapes):
            args = ssd_case(torch, B, S, H, P, N, dtype, seed=200 + i)
            name = f"ssd {dtype} {(B, S, H, P, N, chunk)}"
            y, fin = scan_twice(name, *args, chunk=chunk)
            yr, fr = SS.reference(*args, chunk)
            e = max(check_close(name, y, yr, SSD_TOL),
                    check_close(name + " final", fin, fr, SSD_TOL))
            rows.append(["ssd_scan", str(dtype).split(".")[-1],
                         (B, S, H, P, N, chunk), None, e])
            if i == 0 and dtype == torch.bfloat16:
                err = e
        for S in (512, 500):
            xe, loga, b, c = ssd_case(torch, 1, S, 64, 64, 64, dtype,
                                      seed=300, decay=0.2)
            loga = loga - 0.8
            low = float(loga[:, :128].sum(1).min())
            name = (f"ssd {dtype} S {S} strong decay (L down to {low:.1f} "
                    f"in a chunk)")
            y, fin = scan_twice(name, xe, loga, b, c, chunk=128)
            for what, (yr, fr) in (
                    ("plain", SS.reference(xe, loga, b, c, 128)),
                    ("float64 recurrence", ssd_f64(xe, loga, b, c))):
                e = max(check_close(f"{name} vs {what}", y, yr, SSD_TOL),
                        check_close(f"{name} vs {what} final", fin, fr,
                                    SSD_TOL))
                rows.append(["ssd_scan", str(dtype).split(".")[-1],
                             f"S {S} strong decay, loga ~ -0.8 a step, vs "
                             f"{what}", None, e])
    args = ssd_case(torch, 1, 64, 2, 16, 16, torch.float32, seed=301)
    y, fin = SS.ssd_scan(*args, chunk=32)
    yr, fr = TR.ssd_ref(*args)
    e = max(check_close("ssd vs sequential oracle", y, yr, SSD_TOL),
            check_close("ssd vs sequential oracle final", fin, fr, SSD_TOL))
    rows.append(["ssd_scan", "float32", "sequential oracle (1,64,2,16,16)",
                 None, e])
    return {"ssd_scan": err}


def nc_inputs(torch, n, dtype, seed):
    """n values (n ragged) at several scales with the edge cases spliced
    in, and uniforms that include 0 and the largest float below 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda")
    x *= 10.0 ** torch.randint(-12, 4, (n,), generator=g, device="cuda")
    pw = torch.tensor([2.0 ** k for k in range(-75, 64, 3)], device="cuda")
    low = torch.tensor([2.0 ** -70, 2.0 ** -80, 1e-30, 1e-38, 1e-40, 1e-45,
                        2.0 ** -69], device="cuda")
    high = torch.tensor([2.0 ** 57, 2.0 ** 60, 3e30, 2.0 ** 57 * 1.5],
                        device="cuda")
    edge = torch.cat([torch.zeros(8, device="cuda"), pw, low, high]).to(dtype)
    # float predecessors of the powers of two, in the tensor's own type
    wide = torch.int32 if dtype == torch.float32 else torch.int16
    pred = (pw.to(dtype).view(wide) - 1).view(dtype)
    edge = torch.cat([edge, pred])
    edge = torch.cat([edge, -edge])
    x = x.to(dtype)
    k = min(n, edge.numel())
    idx = torch.randperm(n, generator=g, device="cuda")[:k]
    x[idx] = edge[:k]
    u = torch.rand(n, generator=g, device="cuda")
    u[:2] = torch.tensor([0.0, 1.0 - 2.0 ** -24], device="cuda")
    return x, u


def check_nc(torch, NC, rows):
    """Pack codes and unpacked values bit-identical to the plain versions,
    unpacked values equal to +-2^(code-70); contiguous views at an odd
    element offset take the kernels' unaligned path."""
    sizes = (1, 3, 127, 1000, 4097, 131073, 1024 * 151936 + 5)
    # +-2^(code-70) by code, from Python's exact float powers of two
    # (torch.pow on the card is not exact for every exponent)
    mags = [0.0] + [2.0 ** (c - 70) for c in range(1, 128)]
    exact = torch.tensor(mags + [-m for m in mags], dtype=torch.float64,
                         device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for i, n in enumerate(sizes):
            x, u = nc_inputs(torch, n + 1, dtype, seed=100 + i)
            for off in (0, 1):
                xs, us = x[off:off + n], u[off:off + n]
                codes = NC.nc_pack(xs, us)
                torch.cuda.synchronize()
                ref = NC.pack_reference(xs, us)
                if not torch.equal(codes, ref):
                    bad = int((codes != ref).sum())
                    fail(f"nc_pack {dtype} n={n} off={off}: {bad} codes "
                         f"differ from the plain version")
                for out_dt in (torch.float32, torch.bfloat16):
                    y = NC.nc_unpack(codes, out_dt)
                    torch.cuda.synchronize()
                    yr = NC.unpack_reference(codes, out_dt)
                    wide = torch.int32 if out_dt == torch.float32 else torch.int16
                    if not torch.equal(y.view(wide), yr.view(wide)):
                        fail(f"nc_unpack {out_dt} n={n} off={off}: values "
                             f"differ from the plain version")
                    if not torch.equal(y.double(), exact[codes.long()]):
                        fail(f"nc_unpack {out_dt} n={n}: not +-2^(code-70)")
            a = x[:n].float().abs()
            a = a[a > 0]
            rows.append({"dtype": str(dtype).split(".")[-1], "n": n,
                         "below_range": int((a < NC_LO).sum()),
                         "above_range": int((a >= NC_HI).sum())})
    every = torch.arange(256, device="cuda").to(torch.uint8)
    for out_dt in (torch.float32, torch.bfloat16):
        wide = torch.int32 if out_dt == torch.float32 else torch.int16
        if not torch.equal(NC.nc_unpack(every, out_dt).view(wide),
                           NC.unpack_reference(every, out_dt).view(wide)):
            fail(f"nc_unpack {out_dt}: the 256 codes differ")
    return {"nc_pack": 0.0, "nc_unpack": 0.0}   # bit-identical, or failed


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------
def kernel_cfg(arch):
    """The arch at full width, bf16, with every kernel flag on."""
    from repro_torch.configs import get_config
    return get_config(arch).with_(use_flash_kernel=True,
                                  use_paged_kernel=True, use_ssd_kernel=True)


def plain_cfg(cfg):
    """The same model with every kernel flag off: the plain versions."""
    return cfg.with_(use_flash_kernel=False, use_paged_kernel=False,
                     use_ssd_kernel=False)


def same_share(fins, ref):
    """Share of `ref`'s tokens that `fins` emits at the same place."""
    same = sum(a == b for f, g in zip(fins, ref)
               for a, b in zip(f.tokens, g.tokens))
    return same / sum(len(f.tokens) for f in ref)


def stream_plen(cfg):
    """Prompt lengths of phase 4's stream for cfg: 257-512 tokens, or
    64-320 for whisper's 448-token decoder."""
    return WHISPER_PLEN if cfg.arch_type == "audio" else PLEN


def stream_cache_len(cfg):
    from repro_torch.models.model import n_prefix
    return stream_plen(cfg)[1] + GEN[1] + n_prefix(cfg)


def modality_input(cfg, i):
    """Request i's frontend output, drawn from seed 1000 + i on the card
    in bf16: vlm patches (1, 576, 1024), audio frames (1, 1500, 384);
    None for the text families."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(1000 + i)
    if cfg.arch_type == "vlm":
        shape = (1, cfg.num_patches, 1024)
    elif cfg.arch_type == "audio":
        shape = (1, cfg.encoder_seq, cfg.d_model)
    else:
        return None
    return torch.randn(shape, generator=g, device="cuda").bfloat16()


def make_requests(cfg, Request):
    """REQUESTS requests, seed 0: prompts of 257-512 tokens (whisper:
    64-320), budgets 33-128, and each its modality input."""
    import numpy as np
    rng = np.random.RandomState(0)
    plen = stream_plen(cfg)
    reqs = []
    for i in range(REQUESTS):
        S = int(rng.randint(*plen) + 1)
        reqs.append(Request(rid=i, prompt=rng.randint(0, cfg.vocab_size,
                                                      size=S),
                            max_new_tokens=int(rng.randint(*GEN) + 1),
                            extra_embeds=modality_input(cfg, i)))
    return reqs


def make_engine(cfg, params, ServeEngine, num_pages=None):
    """The paged engine (the dense one for the ssm family, which has no
    K/V to page), its cache long enough for the stream."""
    paged = cfg.arch_type != "ssm"
    return ServeEngine(params, cfg, num_slots=SLOTS,
                       cache_len=stream_cache_len(cfg),
                       page_size=PAGE if paged else None,
                       num_pages=num_pages, device="cuda")


def path_launches(cfg):
    """Kernel launches the path makes: flash an admit, paged a decode
    tick, ssd_scan an admit."""
    L = cfg.num_layers
    if cfg.arch_type == "hybrid":
        return {"flash_attention": L // cfg.hybrid_attn_every,
                "paged_attention": L // cfg.hybrid_attn_every,
                "ssd_scan": L}
    if cfg.arch_type == "ssm":
        return {"flash_attention": 0, "paged_attention": 0, "ssd_scan": 0}
    # audio: the encoder's self-attention and each decoder layer's cross-
    # attention prefill go through flash too
    enc = L + cfg.num_encoder_layers if cfg.arch_type == "audio" else 0
    return {"flash_attention": L + enc, "paged_attention": L, "ssd_scan": 0}


def want_launches(cfg, st, draft_layers=0):
    per = path_launches(cfg)
    return {"flash_attention": ((per["flash_attention"] + draft_layers)
                                * st["prefill_ticks"]),
            "paged_attention": per["paged_attention"] * st["decode_ticks"],
            "ssd_scan": per["ssd_scan"] * st["prefill_ticks"]}


def serve(torch, cfg, params, ops, ServeEngine, Request, num_pages=None,
          engine=None, draft_layers=0, n_requests=REQUESTS,
          split_ticks=False):
    """One warm run of the requests through a fresh paged engine
    (`num_pages` pages, default every slot at full length; or the one
    `engine()` builds), the launch counters zeroed just before and read
    just after.  A model draft's prefill adds `draft_layers` flash
    launches to every admit.  Returns the requests, the finished ones, the
    launches, the engine's stats (with the run's peak device memory, and
    with `split_ticks` the seconds of its admits and decode chunks, a
    synchronize after each), the wall time and the prefill lengths of
    every admit by request id."""
    reqs = make_requests(cfg, Request)[:n_requests]
    eng = (engine() if engine else
           make_engine(cfg, params, ServeEngine, num_pages))
    # warm-up: one short batch over every slot, then a fresh pool
    eng.run([Request(rid=r.rid, prompt=r.prompt, max_new_tokens=WARMUP_GEN,
                     extra_embeds=r.extra_embeds) for r in reqs[:SLOTS]])
    eng.reset()
    admits = []                       # (rid, prefill length) of each admit
    admit = eng._admit

    def recording(req, slot):
        admits.append((req.rid, len(req.prompt)))
        return admit(req, slot)
    eng._admit = recording
    tick_s = {}
    if split_ticks:
        tick = eng.tick

        def timed():
            t = time.perf_counter()
            kind = tick()
            torch.cuda.synchronize()
            tick_s[kind] = tick_s.get(kind, 0.0) + time.perf_counter() - t
            return kind
        eng.tick = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    fins = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {n: getattr(ops, n).launches for n in
                ("flash_attention", "paged_attention", "ssd_scan")}
    if len(fins) != len(reqs):
        fail(f"{len(fins)} of {len(reqs)} requests finished")
    for f, r in zip(fins, reqs):
        if f.rid != r.rid or len(f.tokens) != r.max_new_tokens:
            fail(f"request {r.rid}: {len(f.tokens)} tokens, budget "
                 f"{r.max_new_tokens}")
        if not all(0 <= t < cfg.vocab_size for t in f.tokens):
            fail(f"request {r.rid}: token out of the vocabulary")
    st = dict(eng.stats(), peak_mem_gb=peak / 1e9)
    if split_ticks:
        st["tick_s"] = tick_s
    want = want_launches(cfg, st, draft_layers)
    if launches != want:
        fail(f"{cfg.name} serve run: launches {launches}, want {want} "
             f"({st['prefill_ticks']} admits, {st['decode_ticks']} decode "
             f"ticks)")
    if num_pages is None and st.get("preemptions"):
        fail(f"{cfg.name} serve run: {st['preemptions']} preemptions; the "
             f"pool holds every slot at full length")
    if any(n and not launches[k] for k, n in path_launches(cfg).items()):
        fail(f"{cfg.name} serve run: a kernel of the path never launched")
    return reqs, fins, launches, st, wall, admits


def serve_tight(torch, cfg, params, ops, ServeEngine, Request, ample):
    """The zamba2 requests again on TIGHT_PAGES pages: the pool runs dry
    while slots grow, the youngest is preempted and re-admitted with
    prompt + emitted tokens, a prefill length off the chunk multiples.
    `ample` is the ample-pool run's finished requests: the share of equal
    tokens is reported, not gated (bf16 logits through 38 layers may tie
    differently at another batch composition)."""
    _, fins, launches, st, wall, admits = serve(
        torch, cfg, params, ops, ServeEngine, Request, TIGHT_PAGES)
    if not st["preemptions"]:
        fail(f"{cfg.name} tight pool: no preemption on {TIGHT_PAGES} pages")
    seen, readmits = set(), []
    for rid, n in admits:
        if rid in seen:
            readmits.append(n)
        seen.add(rid)
    if not any(n % cfg.ssm_chunk for n in readmits):
        fail(f"{cfg.name} tight pool: no re-admit off the chunk multiples "
             f"({readmits})")
    return {"num_pages": TIGHT_PAGES, "launches": launches,
            "stats": dict(st, wall_s=wall,
                          tok_s=st["generated_tokens"] / wall),
            "readmit_lens": readmits,
            "same_token_share": same_share(fins, ample)}


# the port's own kernels, by the names of their CUDA functions
PORT_KERNELS = ("flash_fwd", "paged_decode", "paged_merge", "ssd_state",
                "ssd_pass", "ssd_chunk_scan",
                "pack_kernel", "unpack_kernel")


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
    skip, ticks = WINDOW[cfg.name]
    for _ in range(skip):
        eng.tick()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    kinds = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            kinds.append(eng.tick())
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    res["trace"] = dict(trace_summary(prof, window_s), ticks=kinds)
    return res


def trace_summary(prof, window_s):
    """Kernel time by name and the card's busy share (summed kernel time
    over the window's wall time) from a torch.profiler run."""
    avg = prof.key_averages()
    kern = sorted(((r.key, _device_us(r), r.count) for r in avg
                   if str(getattr(r, "device_type", "")).endswith("CUDA")),
                  key=lambda x: -x[1])
    busy_us = sum(us for _, us, _ in kern)
    ours = [{"name": k, "ms": us / 1e3, "count": c} for k, us, c in kern
            if any(n in k for n in PORT_KERNELS)]
    return {
        "window_s": window_s, "kernel_s": busy_us / 1e6,
        "kernel_launches": sum(c for *_, c in kern),
        "cpu_ops": sum(r.count for r in avg
                       if str(getattr(r, "device_type", "")).endswith("CPU")),
        "busy_share": (busy_us / 1e6 / window_s) if busy_us else None,
        "top_kernels": [{"name": k, "ms": us / 1e3, "count": c}
                        for k, us, c in kern[:15]],
        "port_kernels": ours}


def print_trace(card, what, trace):
    print(f"{what} [{card}]: "
          f"{json.dumps(dict(trace, top_kernels=None, port_kernels=None))}")
    for k in trace["top_kernels"]:
        print(f"  kernel [{card}] {k['ms']:.3f} ms x{k['count']} "
              f"{k['name'][:100]}")
    for k in trace["port_kernels"]:
        print(f"  port kernel [{card}] {k['ms']:.3f} ms x{k['count']} "
              f"({k['ms'] / k['count']:.4f} ms each) {k['name'][:80]}")


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def routed(M, cfg, fn, force=None):
    """fn() with every MoE layer's routing recorded: (fn's result, the
    experts each layer chose, (G, n, k) a layer, each token's choices as
    sorted (expert, kept) codes, (tokens, k) a layer, and the router's
    probabilities, (G, n, E) a layer).  With `force` (the experts of
    another run, a list of one tensor a layer) every layer takes those
    experts instead of its own top-k, gated by its own router's
    probabilities.  The lists stay empty without MoE."""
    chosen, codes, probs_of = [], [], []
    top_k, slots = M.top_k, M.moe_slots

    def pick(probs, k):
        if force is None:
            gates, idx = top_k(probs, k)
        else:
            idx = force[len(chosen)]
            gates = probs.gather(-1, idx)
        chosen.append(idx)
        probs_of.append(probs)
        return gates, idx

    def record(eidx, E, C):
        rows, s2s = slots(eidx, E, C)
        code = eidx * 2 + (rows < E * C).long()
        codes.append(code.reshape(-1, cfg.top_k).sort(-1).values)
        return rows, s2s
    M.top_k, M.moe_slots = pick, record
    try:
        out = fn()
    finally:
        M.top_k, M.moe_slots = top_k, slots
    return out, chosen, codes, probs_of


def attended(A, fn, attend=None):
    """fn() with the first layer's prefill attention output kept: (fn's
    result, that output).  With `attend`, every layer's prefill attention
    runs it in place of the model's own."""
    own, first = A.gqa_attend, []

    def keep(*a, **kw):
        out = (attend or own)(*a, **kw)
        if not first:
            first.append(out)
        return out
    A.gqa_attend = keep
    try:
        out = fn()
    finally:
        A.gqa_attend = own
    return out, first[0]


def sdpa_attend(q, k, v, cfg, *, causal=True, window=None):
    """The prefill attention as torch's scaled_dot_product_attention: a
    third correct bf16 attention, for the routing control."""
    if window is not None:
        raise ValueError("the routing control takes no window")
    out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               is_causal=causal)
    return out.transpose(1, 2)


def layer0_flips(torch, cfg, kchosen, pchosen, kprobs, pprobs):
    """The first MoE layer's routing, two paths on the same layer input:
    the tokens whose expert sets differ, each with the plain path's gap
    between its k-th and (k+1)-th router probability and the largest
    change of any of its probabilities between the paths.  A flip needs
    gap <= 2 x that change (the two swapped experts' probabilities cross);
    the change comes from the attention difference held before it."""
    k = cfg.top_k
    kc = kchosen[0].reshape(-1, k).sort(-1).values
    pc = pchosen[0].reshape(-1, k).sort(-1).values
    pp = pprobs[0].reshape(kc.shape[0], -1)
    change = (kprobs[0].reshape(pp.shape) - pp).abs().max(-1).values
    top = pp.topk(k + 1, dim=-1).values
    gap = top[:, k - 1] - top[:, k]
    flip = (kc != pc).any(-1)
    g, c = gap[flip], change[flip]
    ratio = float((g / (2 * c).clamp(min=1e-30)).max()) if len(g) else 0.0
    return {"tokens": kc.shape[0], "flipped": int(flip.sum()),
            "gap_flipped_max": float(g.max()) if len(g) else None,
            "gap_over_2change_max": ratio,
            "gap_all_median": float(gap.median()),
            "change_all_median": float(change.median()),
            "change_all_max": float(change.max())}


def route_agreement(torch, a, b):
    """Two paths' recorded choices: {(token, layer) pairs, the pairs
    whose choices differ, tokens, tokens that differ at some layer, and
    by layer the tokens whose choices first differ there}."""
    diff = torch.stack([(x != y).any(-1) for x, y in zip(a, b)])
    anyd = diff.any(0)
    first = diff.int().argmax(0)[anyd].tolist()
    return {"pairs": diff.numel(), "differ": int(diff.sum()),
            "tokens": diff.shape[1], "tokens_differ": int(anyd.sum()),
            "first_differ_by_layer": {l: first.count(l)
                                      for l in sorted(set(first))}}


def hold_logits(what, lk, lp):
    """Kernel-path logits lk against plain-path lp, every row: max |diff|
    within LOGIT_TOL x max(1, max|plain logit|).  Returns (err, scale)."""
    a, b = lk.float(), lp.float()
    scale = max(1.0, float(b.abs().max()))
    err = max_err(a, b)
    if err > LOGIT_TOL * scale:
        fail(f"{what} logits differ by {err} (> {LOGIT_TOL} x {scale})")
    return err, scale


def compare_plain_paths(torch, cfg, params, MD, SS, reqs):
    """Prefill (flash, and ssd_scan in the hybrid) and one paged decode
    tick (paged kernel) with the kernel flags on, against the same with
    them off: the last prefill position's logits and the decode rows'.
    In the hybrid, the plain path's scan is wrapped: at every Mamba2
    layer the kernel runs on the very inputs the plain scan got, and its
    y and final state are held to SSD_TOL of their largest entry (later
    layers' inputs differ between the two whole paths, so the paths'
    states tell kernel error and bf16 drift apart only there).
    In a MoE model the bf16 difference between the attention paths flips
    router near-ties (top-8 of 128 at qwen3-moe's width: about one token
    in twenty at the first layer), and a flip swaps an expert's whole
    contribution, so the token's later layers route apart too.  The plain
    path runs three times: on its own routing, where the (token, layer)
    choices that differ from the kernel path's are counted and reported;
    with the kernel path's expert choices, where every prefill position's
    and every decode row's logits are held; and with SDPA for its prefill
    attention, a control whose flips against the plain path are reported
    beside the kernel's.  At the first layer both paths see the same
    input: there the flash output is held to the bf16 kernel tolerance,
    and every flipped token must be a near-tie the measured change of
    its router probabilities crosses (`layer0_flips`)."""
    from repro_torch.models import attention as A
    from repro_torch.models import mlp as M
    from repro_torch.models import ssm as SSM
    plain = plain_cfg(cfg)
    moe = cfg.arch_type == "moe"
    res = {}
    prompts = [torch.as_tensor(r.prompt, device="cuda")[None].int()
               for r in reqs[:2]]
    extras = [r.extra_embeds for r in reqs[:2]]
    layer_err = []
    scan = SSM.ssd_scan_ref

    def held(xe, loga, b, c, chunk):
        yp, fp = scan(xe, loga, b, c, chunk)
        yk, fk = SS.ssd_scan(xe.contiguous(), loga.contiguous(),
                             b.contiguous(), c.contiguous(), chunk=chunk)
        layer_err.append(max(max_err(yk, yp) / float(yp.abs().max()),
                             max_err(fk, fp) / float(fp.abs().max())))
        return yp, fp

    def prefill(c, force=None, attend=None):
        return attended(A, lambda: routed(M, cfg, lambda: MD.forward(
            params, c, prompts[0], extra_embeds=extras[0],
            return_cache=True), force), attend)
    ((lk, _, ck), kchosen, kcodes, kprobs), katt = prefill(cfg)
    SSM.ssd_scan_ref = held
    try:
        ((lp, _, cp), pchosen, pcodes, pprobs), patt = prefill(plain)
    finally:
        SSM.ssd_scan_ref = scan
    for name, a in (("kernel", lk), ("plain", lp)):
        if not bool(torch.isfinite(a.float()).all()):
            fail(f"prefill logits ({name} path) not finite")
    same = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    if moe:                     # every position, the same experts
        ref = prefill(plain, kchosen)[0][0][0]
        err, scale = hold_logits("prefill", lk[0], ref[0])
        att_err = check_close("layer-0 attention, kernel vs plain path",
                              katt, patt, TOL["bfloat16"])
        flips = layer0_flips(torch, cfg, kchosen, pchosen, kprobs, pprobs)
        if not flips["gap_over_2change_max"] <= 1.0:
            fail(f"layer-0 routing: a flipped token's top-k gap is "
                 f"{flips['gap_over_2change_max']} x twice its router "
                 f"probabilities' change: not a near-tie")
        (_, schosen, scodes, sprobs), _ = prefill(plain,
                                                  attend=sdpa_attend)
        control = route_agreement(torch, scodes, pcodes)
        control["layer0"] = layer0_flips(torch, cfg, schosen, pchosen,
                                         sprobs, pprobs)
        del schosen, scodes, sprobs
    else:
        err, scale = hold_logits("prefill last-position", lk[0, -1],
                                 lp[0, -1])
    res["prefill"] = {"S": prompts[0].shape[1], "max_abs_err": err,
                      "logit_scale": scale, "greedy_same_share": same}
    if cfg.arch_type == "hybrid":
        if len(layer_err) != cfg.num_layers:
            fail(f"per-layer scan check: {len(layer_err)} layers held, "
                 f"want {cfg.num_layers}")
        worst = max(range(len(layer_err)), key=layer_err.__getitem__)
        if not layer_err[worst] <= SSD_TOL:
            fail(f"ssd_scan vs plain on layer {worst}'s inputs: "
                 f"{layer_err[worst]} of the largest entry (> {SSD_TOL})")
        rel = [max_err(a, b) / float(b.abs().max())
               for a, b in zip(ck["ssm"], cp["ssm"])]
        res["prefill"].update(ssd_layers_held=len(layer_err),
                              ssd_rel_err_worst_layer=worst,
                              ssd_rel_err_worst=layer_err[worst],
                              ssm_state_path_rel_err_max=max(rel))
    del ck, cp

    # a paged pool holding both prompts on scrambled pages (a vlm's
    # patches before its prompt; audio's cross-K/V as the slots' rows)
    n_max = -(-stream_cache_len(cfg) // PAGE)
    Np = 2 * n_max
    pool = MD.init_paged_cache(cfg, 2, Np, PAGE, "cuda")
    ids = torch.randperm(Np, generator=torch.Generator().manual_seed(3)
                         ).reshape(2, n_max).int().cuda()
    toks, pos = [], []
    for b, p in enumerate(prompts):
        S = p.shape[1] + MD.n_prefix(cfg)
        npg = -(-(S + 1) // PAGE)
        lg, _, c = MD.forward(params, cfg, p, extra_embeds=extras[b],
                              return_cache=True, cache_len=npg * PAGE)
        MD.write_paged_cache(pool, c, b, ids[b, :npg], cfg)
        toks.append(int(lg[0, -1].argmax()))
        pos.append(S)
    tok = torch.tensor(toks, device="cuda", dtype=torch.int32)[:, None]
    pos = torch.tensor(pos, device="cuda", dtype=torch.int32)
    active = torch.ones(2, dtype=torch.bool, device="cuda")
    pools = [clone_tree(pool) for _ in range(2 if moe else 1)]

    def decode(c, cache, force=None):
        return routed(M, cfg, lambda: MD.decode_step(
            params, c, tok, pos, cache, active=active, block_tables=ids,
            logical_len=n_max * PAGE), force)
    (dk, _), dchosen, dkcodes, _ = decode(cfg, pool)
    (dp, _), _, dpcodes, _ = decode(plain, pools[0])
    ref = decode(plain, pools[1], dchosen)[0][0] if moe else dp
    err, scale = hold_logits("paged decode", dk, ref)
    same = float((dk.argmax(-1) == dp.argmax(-1)).float().mean())
    res["decode"] = {"B": 2, "max_abs_err": err, "logit_scale": scale,
                     "greedy_same_share": same}
    if moe:
        pre = route_agreement(torch, kcodes, pcodes)
        dec = route_agreement(torch, dkcodes, dpcodes)
        res["routing"] = {
            "pairs": pre["pairs"] + dec["pairs"],
            "differ": pre["differ"] + dec["differ"],
            "share": ((pre["differ"] + dec["differ"])
                      / (pre["pairs"] + dec["pairs"])),
            "prefill": pre, "decode": dec,
            "layer0": dict(flips, attention_max_abs_err=att_err,
                           attention_max_abs=float(patt.float().abs().max())),
            "sdpa_control": control}
    return res


# ---------------------------------------------------------------------------
# phase 5: times and bounds
# ---------------------------------------------------------------------------
# timed shapes (Hq, Hk, dh) of the serve paths' attention
HEADS = {ARCH: (16, 8, 128), HYBRID: (32, 32, 64), TARGET: (16, 8, 128),
         MOE: (32, 4, 128), DENSE7B: (32, 32, 128), ARCTIC: (56, 8, 128),
         WHISPER: (6, 6, 64), VLM: (32, 32, 96), NEMOTRON: (96, 8, 192)}


def time_flash(torch, FA, heads, S=512, T=None, causal=True):
    """Causal prefill of S tokens, or a non-causal read of T keys."""
    B, (Hq, Hk, dh), T = 1, heads, T or S
    g = torch.Generator(device="cuda").manual_seed(42)
    q = torch.randn(B, S, Hq, dh, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, T, Hk, dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, T, Hk, dh, generator=g, device="cuda").bfloat16()
    ms = device_ms(lambda: FA.flash_attention(q, k, v, causal=causal))
    call_ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=causal))
    plain_ms = device_ms(lambda: FA.reference(q, k, v, causal=causal), n=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = device_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
    # (query, key) pairs attended: the causal triangle (S == T), or all
    pairs = S * (S + 1) // 2 if causal else S * T
    flops = 4 * B * Hq * dh * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, k, v, out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    shape = [B, S, Hq, Hk, dh] if causal else [B, S, T, Hq, Hk, dh]
    return {"shape": shape, "causal": causal, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "library_ms": lib_ms, "library": "scaled_dot_product_attention",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def time_paged(torch, PA, heads, pos_list, cache_len=PLEN[1] + GEN[1]):
    (Hq, Hk, dh), B, P = heads, len(pos_list), PAGE
    n_max = -(-cache_len // P)
    Np = B * n_max
    g = torch.Generator(device="cuda").manual_seed(43)
    q = torch.randn(B, Hq, dh, generator=g, device="cuda").bfloat16()
    kp = torch.randn(Np + 1, P, Hk, dh, generator=g, device="cuda").bfloat16()
    vp = torch.randn(Np + 1, P, Hk, dh, generator=g, device="cuda").bfloat16()
    bt = torch.randperm(Np, generator=torch.Generator().manual_seed(4)
                        ).reshape(B, n_max).int().cuda()
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    ms = device_ms(lambda: PA.paged_attention(q, kp, vp, bt, pos), n=50)
    call_ms = cuda_ms(lambda: PA.paged_attention(q, kp, vp, bt, pos), n=50)
    plain_ms = device_ms(lambda: PA.reference(q, kp, vp, bt, pos), n=10)
    C = n_max * P
    valid = (torch.arange(C, device="cuda")[None] <= pos[:, None].long())
    mask = valid[:, None, None, :]                 # (B,1,1,C)
    qs = q[:, :, None, :]                          # (B,Hq,1,dh)

    def library():
        kg = kp[bt.long()].reshape(B, C, Hk, dh).transpose(1, 2)
        vg = vp[bt.long()].reshape(B, C, Hk, dh).transpose(1, 2)
        return sdpa(qs, kg, vg, attn_mask=mask)
    lib_ms = device_ms(library, n=50)
    resident = sum(p + 1 for p in pos_list)        # positions attended
    nbytes = (2 * resident * Hk * dh * 2           # K and V, bf16
              + 2 * 2 * q.numel()                  # q and out
              + 4 * (bt.numel() + B))              # block tables and pos
    flops = 4 * Hq * dh * resident
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    n_splits, span = PA.plan_splits(B, Hk, n_max, P)
    return {"shape": [B, Hq, Hk, dh, P, n_max], "pos": pos_list, "ms": ms,
            "call_ms": call_ms,
            "splits": n_splits, "span": span,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "gather + scaled_dot_product_attention",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def time_paged_verify(torch, PA, heads, pos_list, S=SPEC_K + 1):
    """The paged kernel at the verify shape: every slot's S candidate rows
    as B*S query rows, row (b, i) through table row b at position
    pos[b] + i (what attention_verify launches).  Library: the slots'
    K/V gathered once, then one scaled_dot_product_attention of S queries
    a slot under the candidates' causal mask."""
    (Hq, Hk, dh), B, P = heads, len(pos_list), PAGE
    n_max = -(-(PLEN[1] + GEN[1]) // P)
    Np = B * n_max
    g = torch.Generator(device="cuda").manual_seed(46)
    q = torch.randn(B * S, Hq, dh, generator=g, device="cuda").bfloat16()
    kp = torch.randn(Np + 1, P, Hk, dh, generator=g, device="cuda").bfloat16()
    vp = torch.randn(Np + 1, P, Hk, dh, generator=g, device="cuda").bfloat16()
    bt8 = torch.randperm(Np, generator=torch.Generator().manual_seed(5)
                         ).reshape(B, n_max).int().cuda()
    bt = bt8.repeat_interleave(S, dim=0)
    base = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    pos = (base[:, None] + torch.arange(S, device="cuda")).reshape(-1).int()
    ms = device_ms(lambda: PA.paged_attention(q, kp, vp, bt, pos), n=50)
    call_ms = cuda_ms(lambda: PA.paged_attention(q, kp, vp, bt, pos), n=50)
    plain_ms = device_ms(lambda: PA.reference(q, kp, vp, bt, pos), n=10)
    C = n_max * P
    qpos = pos.reshape(B, S).long()
    mask = (torch.arange(C, device="cuda")[None, None] <= qpos[:, :, None]
            )[:, None]                                   # (B,1,S,C)
    qs = q.reshape(B, S, Hq, dh).transpose(1, 2)         # (B,Hq,S,dh)

    def library():
        kg = kp[bt8.long()].reshape(B, C, Hk, dh).transpose(1, 2)
        vg = vp[bt8.long()].reshape(B, C, Hk, dh).transpose(1, 2)
        return sdpa(qs, kg, vg, attn_mask=mask)
    lib_ms = device_ms(library, n=50)
    resident = sum(p + S for p in pos_list)        # positions a slot holds
    attended = int((pos.long() + 1).sum())         # (query, key) pairs
    nbytes = (2 * resident * Hk * dh * 2           # K and V, bf16
              + 2 * 2 * q.numel()                  # q and out
              + 4 * (bt.numel() + B * S))          # block tables and pos
    flops = 4 * Hq * dh * attended
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    n_splits, span = PA.plan_splits(B * S, Hk, n_max, P)
    return {"shape": [B * S, Hq, Hk, dh, P, n_max], "pos": pos_list,
            "rows": f"{B} slots x S {S}", "ms": ms, "call_ms": call_ms,
            "splits": n_splits, "span": span,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "gather + scaled_dot_product_attention",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def time_ssd(torch, SS, shape=(1, 512, 64, 64, 64, 128)):
    """The SSD scan at zamba2-1.2b's 512-token prefill: xe, b, c bf16 and
    loga fp32 as the model gives them.  Operations, the least the scan
    needs: the causal half of the (Q,Q) c b^T once per chunk (b and c are
    shared across heads); per chunk and head the causal half of the
    scores-times-xe product, the inter-chunk term and the chunk state; no
    single PyTorch call computes the scan (library none)."""
    B, S, H, P, N, Q = shape
    xe, loga, b, c = ssd_case(torch, B, S, H, P, N, torch.bfloat16, seed=45)
    ms = device_ms(lambda: SS.ssd_scan(xe, loga, b, c, chunk=Q), n=50)
    call_ms = cuda_ms(lambda: SS.ssd_scan(xe, loga, b, c, chunk=Q), n=50)
    plain_ms = device_ms(lambda: SS.reference(xe, loga, b, c, Q), n=10)
    nc = -(-S // Q)
    tri = Q * (Q + 1) // 2
    flops = 2 * B * nc * (tri * N + H * (tri * P + 2 * Q * N * P))
    nbytes = (xe.numel() * 2 + loga.numel() * 4 + 2 * b.numel() * 2
              + 4 * xe.numel() + 4 * B * H * N * P)     # + y and final
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"shape": list(shape), "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "library_ms": None, "library": "none",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def nc_bound(n_in_bytes, n_out_bytes):
    """(bound ms, 'bytes'): a few integer operations per element never
    bound these kernels; each input byte read once, each output written
    once, at the card's memory rate."""
    return 1e3 * (n_in_bytes + n_out_bytes) / PEAK_BYTES, "bytes"


def time_nc(torch, NC, leaves):
    """nc_pack / nc_unpack at the embed leaf (the train path's largest,
    one launch each) and over one step's gradient leaves (14 launches
    each), bf16 gradients and fp32 uniforms as the train step gives them."""
    g = torch.Generator(device="cuda").manual_seed(44)
    xs = [(torch.randn(s, generator=g, device="cuda") * 1e-3).bfloat16()
          for s in leaves]
    us = [torch.rand(s, generator=g, device="cuda") for s in leaves]
    cs = [NC.nc_pack(x, u) for x, u in zip(xs, us)]
    big = max(range(len(leaves)), key=lambda i: xs[i].numel())
    res = {}
    for scope, idx in (("embed", [big]), ("step", list(range(len(xs))))):
        n = sum(xs[i].numel() for i in idx)
        pk = cuda_ms(lambda: [NC.nc_pack(xs[i], us[i]) for i in idx], n=10)
        pk_plain = cuda_ms(lambda: [NC.pack_reference(xs[i], us[i])
                                    for i in idx], n=3, warmup=1)
        up = cuda_ms(lambda: [NC.nc_unpack(cs[i], torch.bfloat16)
                              for i in idx], n=10)
        up_plain = cuda_ms(lambda: [NC.unpack_reference(cs[i], torch.bfloat16)
                                    for i in idx], n=3, warmup=1)
        pb, pby = nc_bound(n * (2 + 4), n)
        ub, uby = nc_bound(n, 2 * n)
        res[scope] = {
            "elements": n, "launches": len(idx),
            "shape": list(xs[big].shape) if scope == "embed" else None,
            "nc_pack": {"ms": pk, "plain_ms": pk_plain, "bound_ms": pb,
                        "bound_by": pby, "library_ms": None,
                        "bytes": n * 7},
            "nc_unpack": {"ms": up, "plain_ms": up_plain, "bound_ms": ub,
                          "bound_by": uby, "library_ms": None,
                          "bytes": n * 3}}
    return res


# ---------------------------------------------------------------------------
# phase 6: train at full width with compressed gradients
# ---------------------------------------------------------------------------
def train_phase(torch, cfg, ops, NC, profile=False):
    from repro_torch.core.compression import draw_uniforms
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import (apply_grads, loss_and_grads,
                                          make_train_step)
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.optimizers import adamw, warmup_cosine

    def same_bits(a, b):
        """Two trees equal bit for bit (-0.0 and 0.0 differ)."""
        return all(torch.equal(bits(torch, x), bits(torch, y))
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    B, S = TRAIN_BATCH, TRAIN_SEQ
    total = 1 + TRAIN_STEPS
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_leaves = len(tree_leaves(params))
    opt = adamw(warmup_cosine(3e-3, TRAIN_WARMUP, total))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, compress_grads=True)
    batches = iter(make_pipeline(cfg.vocab_size, B, S, seed=0))

    def batch():
        return {k: torch.from_numpy(v).cuda() for k, v in next(batches).items()}

    def noise(step):
        return torch.Generator(device="cuda").manual_seed(1 + step)

    losses = []
    params, state, m = step_fn(params, state, batch(), noise(0))   # warm-up
    losses.append(float(m["loss"]))
    data = [batch() for _ in range(TRAIN_STEPS)]    # host sampling untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    for i, b in enumerate(data):
        params, state, m = step_fn(params, state, b, noise(1 + i))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: getattr(ops, n).launches for n in
                ("nc_pack", "nc_unpack", "flash_attention", "paged_attention")}
    peak = torch.cuda.max_memory_allocated()
    want = n_leaves * TRAIN_STEPS
    if launches["nc_pack"] != want or launches["nc_unpack"] != want:
        fail(f"train run: nc launches {launches}, want {want} each "
             f"({n_leaves} gradient leaves x {TRAIN_STEPS} steps)")
    if launches["flash_attention"] or launches["paged_attention"]:
        fail(f"train run launched an attention kernel: {launches}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        fail(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train loss did not fall: {losses}")

    # one step split, a synchronize between the parts
    b = batch()
    split = {}
    t = time.perf_counter()
    loss, grads = loss_and_grads(params, cfg, b)
    torch.cuda.synchronize()
    split["forward_backward_ms"] = 1e3 * (time.perf_counter() - t)
    u = draw_uniforms(grads, noise(total))
    torch.cuda.synchronize()
    t = time.perf_counter()
    ck = tree_map(ops.nc_roundtrip, grads, u)
    torch.cuda.synchronize()
    split["compression_ms"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    pk, sk, _ = apply_grads(opt, params, state, ck)
    torch.cuda.synchronize()
    split["optimizer_ms"] = 1e3 * (time.perf_counter() - t)

    # the same gradients and uniforms through the plain round trip
    cp = tree_map(lambda g, v: NC.unpack_reference(NC.pack_reference(g, v),
                                                   g.dtype), grads, u)
    if not same_bits(ck, cp):
        fail("compressed gradients: kernels and plain versions differ")
    pp, sp, _ = apply_grads(opt, params, state, cp)
    if not (same_bits(pk, pp) and same_bits(sk["mu"], sp["mu"])
            and same_bits(sk["nu"], sp["nu"])):
        fail("params after the kernel step and the plain step differ")
    del u, ck, cp, pk, sk, pp, sp
    trace = None
    if profile:        # one more step under the profiler
        b = batch()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            step_fn(params, state, b, noise(total + 1))
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t
        trace = trace_summary(prof, window_s)
    gl = [g.float().abs() for g in tree_leaves(grads)]
    outside = {"zero": sum(int((a == 0).sum()) for a in gl),
               "below_2^-69": sum(int(((a > 0) & (a < NC_LO)).sum())
                                  for a in gl),
               "at_or_above_2^57": sum(int((a >= NC_HI).sum()) for a in gl)}
    return {"batch": B, "seq": S, "steps": TRAIN_STEPS, "losses": losses,
            "wall_s": wall, "ms_per_step": 1e3 * wall / TRAIN_STEPS,
            "tok_s": B * S * TRAIN_STEPS / wall, "peak_mem_gb": peak / 1e9,
            "launches": launches, "n_leaves": n_leaves, "split": split,
            "grad_elements": sum(a.numel() for a in gl),
            "grad_range": outside, "compare_loss": float(loss),
            "trace": trace}


def serve_path(torch, card, arch, ops, MD, SS, ServeEngine, Request,
               profile=False):
    """Phase 4 for one model: the warm serve run with its launch counts,
    the --profile split and trace, kernel path vs plain path, and for the
    hybrid the tight-pool run that preempts."""
    from repro_torch.models.config import param_count
    cfg = kernel_cfg(arch)
    total, _ = param_count(cfg)
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    reqs, fins, launches, st, wall, _ = serve(torch, cfg, params, ops,
                                              ServeEngine, Request)
    tps = st["generated_tokens"] / wall
    print(f"serve [{card}]: {arch} {total / 1e6:.1f}M params bf16, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{SLOTS} slots, {REQUESTS} requests, warm run: "
          f"{st['generated_tokens']} tokens in {wall:.2f} s = "
          f"{tps:.1f} tok/s, admits={st['prefill_ticks']} "
          f"prefill_tokens={st['prefill_tokens']} "
          f"decode_ticks={st['decode_ticks']} "
          f"occupancy={st['occupancy']:.3f} "
          f"pool_occupancy={st['pool_occupancy']:.3f} "
          f"preemptions={st['preemptions']} launches={launches}")
    prof = None
    if profile:
        prof = profile_serve(torch, cfg, params, ServeEngine, Request)
        print(f"split [{card}] {arch}: {json.dumps(prof['split'])}")
        print_trace(card, f"trace {arch}", prof["trace"])
    plain = compare_plain_paths(torch, cfg, params, MD, SS, reqs)
    print(f"kernel vs plain path [{card}] {arch}: {json.dumps(plain)}")
    tight = None
    if cfg.arch_type == "hybrid":
        tight = serve_tight(torch, cfg, params, ops, ServeEngine, Request,
                            fins)
        ts = tight["stats"]
        print(f"serve tight pool [{card}]: {arch} {TIGHT_PAGES} pages: "
              f"{ts['generated_tokens']} tokens in {ts['wall_s']:.2f} s = "
              f"{ts['tok_s']:.1f} tok/s, admits={ts['prefill_ticks']} "
              f"preemptions={ts['preemptions']} re-admit prefills "
              f"{tight['readmit_lens']}, tokens equal to the ample run's "
              f"{tight['same_token_share']:.3f}, "
              f"launches={tight['launches']}")
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "params": total, "launches": launches,
            "stats": dict(st, wall_s=wall, tok_s=tps), "profile": prof,
            "plain_paths": plain, "tight_pool": tight}, fins


# ---------------------------------------------------------------------------
# phase 4b: speculative decoding, drain and migrate
# ---------------------------------------------------------------------------
def near_argmax(torch, MD, cfg, params, reqs, fins):
    """Each emitted token against a teacher-forced plain-path forward of
    the target over prompt + emitted: its logit within LOGIT_TOL x
    max(1, max|logit|) of its row's maximum.  Returns the largest gap,
    in units of the row's scale."""
    import numpy as np
    plain = plain_cfg(cfg)
    worst = 0.0
    for r, f in zip(reqs, fins):
        n, g = len(r.prompt), len(f.tokens)
        toks = np.concatenate([np.asarray(r.prompt), f.tokens[:-1]])
        logits, _, _ = MD.forward(params, plain, torch.as_tensor(
            toks, dtype=torch.int32, device="cuda")[None])
        rows = logits[0, n - 1:n - 1 + g].float()
        got = rows.gather(1, torch.as_tensor(f.tokens, device="cuda")
                          .long()[:, None])[:, 0]
        scale = rows.abs().max(-1).values.clamp(min=1.0)
        gap = float(((rows.max(-1).values - got) / scale).max())
        if not gap <= LOGIT_TOL:
            fail(f"{cfg.name} request {r.rid}: an emitted token is "
                 f"{gap:.4f} of its row's scale below the teacher-forced "
                 f"maximum (> {LOGIT_TOL})")
        worst = max(worst, gap)
    return worst



def spec_phase(torch, card, ops, MD):
    """qwen3-1.7b at full width through the paged engine three times on
    phase 4's stream: plain, with the lookup draft (k 3), and with
    qwen3-0.6b drafting (k 3); then qwen3-0.6b drafting for itself on 4
    requests, which must accept all k in at least one round."""
    from repro_torch.models.config import param_count
    from repro_torch.serving import (LookupDraft, ModelDraft, Request,
                                     ServeEngine, SpecDecodeEngine)
    tcfg, dcfg = kernel_cfg(TARGET), kernel_cfg(ARCH)
    tparams = MD.init_model(tcfg, torch.Generator(device="cuda").manual_seed(0))
    dparams = MD.init_model(dcfg, torch.Generator(device="cuda").manual_seed(
        DRAFT_SEED))
    cache_len = PLEN[1] + GEN[1]

    def spec(params, cfg, draft):
        return lambda: SpecDecodeEngine(
            params, cfg, num_slots=SLOTS, cache_len=cache_len + SPEC_K,
            page_size=PAGE, draft=draft, spec_k=SPEC_K, device="cuda")

    runs = {}
    plain_fins = None
    for name, make, dl in (
            (f"{TARGET} serve", None, 0),
            (f"{TARGET} spec lookup", spec(tparams, tcfg, LookupDraft()), 0),
            (f"{TARGET} spec draft {ARCH}",
             spec(tparams, tcfg, ModelDraft(dparams, dcfg)),
             dcfg.num_layers)):
        reqs, fins, launches, st, wall, _ = serve(
            torch, tcfg, tparams, ops, ServeEngine, Request, engine=make,
            draft_layers=dl)
        gap = near_argmax(torch, MD, tcfg, tparams, reqs, fins)
        plain_fins = plain_fins or fins
        rec = {"launches": launches, "stats": dict(
            st, wall_s=wall, tok_s=st["generated_tokens"] / wall),
            "near_argmax_worst_gap": gap,
            "same_token_share": same_share(fins, plain_fins)}
        runs[name] = rec
        extra = ""
        if make:
            extra = (f"rounds={st['spec_rounds']} "
                     f"accept_rate={st['accept_rate']:.3f} "
                     f"tokens/round={st['tokens_per_round']:.3f} "
                     f"full-accept row-rounds={st['spec_full_accepts']} ")
        print(f"spec [{card}]: {name}: {st['generated_tokens']} "
              f"tokens in {wall:.2f} s = {st['generated_tokens'] / wall:.1f}"
              f" tok/s, admits={st['prefill_ticks']} decode "
              f"{'rounds' if make else 'ticks'}={st['decode_ticks']} "
              f"{extra}tokens equal to the plain run's "
              f"{rec['same_token_share']:.3f}, worst near-argmax gap "
              f"{gap:.4f} (<= {LOGIT_TOL}), launches={launches}")
    del tparams
    torch.cuda.empty_cache()
    # the draft drafting for itself: agrees with every proposal up to
    # near-ties between its dense plain decode and the paged verify
    reqs, fins, launches, st, wall, _ = serve(
        torch, dcfg, dparams, ops, ServeEngine, Request,
        engine=spec(dparams, dcfg, ModelDraft(dparams, dcfg)),
        draft_layers=dcfg.num_layers, n_requests=SELF_DRAFT_REQUESTS)
    if not st["spec_full_accepts"]:
        fail(f"self-draft: no round accepted all {SPEC_K} proposals "
             f"({st['spec_rounds']} rounds, accept rate "
             f"{st['accept_rate']:.3f})")
    gap = near_argmax(torch, MD, dcfg, dparams, reqs, fins)
    runs[f"{ARCH} spec self-draft"] = {"launches": launches, "stats": dict(
        st, wall_s=wall), "near_argmax_worst_gap": gap}
    print(f"spec [{card}]: {ARCH} drafting for itself, "
          f"{SELF_DRAFT_REQUESTS} requests: rounds={st['spec_rounds']} "
          f"accept_rate={st['accept_rate']:.3f} "
          f"tokens/round={st['tokens_per_round']:.3f} full-accept "
          f"row-rounds={st['spec_full_accepts']}, worst near-argmax gap "
          f"{gap:.4f}, launches={launches}")
    del dparams
    torch.cuda.empty_cache()
    total, _ = param_count(tcfg)
    return {"target": TARGET, "target_params": total, "draft": ARCH,
            "spec_k": SPEC_K, "runs": runs}


def drain_phase(torch, card, arch, ops, MD, ample):
    """Phase 4's stream on a paged engine, drained after DRAIN_TICKS
    ticks; the drained requests re-admitted through ServingDrainReadmit
    onto a second engine, each harvested page and row read back right
    after its install (bit-equal), the outputs stitched.  `ample` is
    phase 4's run of the same stream without the drain: the share of
    equal tokens is reported, not gated (another batch composition may
    break a bf16 near-tie another way)."""
    from repro_torch.elastic import ServingDrainReadmit
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.serving import Request, ServeEngine
    cfg = kernel_cfg(arch)
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    reqs = make_requests(cfg, Request)

    def counted(run, eng):
        torch.cuda.synchronize()
        ops.reset_launches()
        out = run()
        torch.cuda.synchronize()
        got = {n: getattr(ops, n).launches for n in
               ("flash_attention", "paged_attention", "ssd_scan")}
        st = eng.stats()
        want = want_launches(cfg, st)
        if got != want:
            fail(f"{arch} drain: launches {got}, want {want}")
        if st["preemptions"]:
            fail(f"{arch} drain: {st['preemptions']} preemptions")
        return out, got

    a = make_engine(cfg, params, ServeEngine)

    def first():
        for r in reqs:
            a.submit(r)
        for _ in range(DRAIN_TICKS):
            a.tick()
        return a.drain()
    drained, launches_a = counted(first, a)
    harvested = {d.request.rid for d in drained if d.kv is not None}
    if len(harvested) < 3:
        fail(f"{arch} drain: {len(harvested)} slots harvested, want >= 3")
    policy = ServingDrainReadmit()
    conts = policy.readmit(drained)
    b = make_engine(cfg, params, ServeEngine)
    installed, prefilled = [], []
    install, admit = b._admit_migrated, b._admit

    def read_back(req, slot):
        install(req, slot)
        kv = req.kv_seed
        n = next(iter(kv.pages.values())).shape[1]
        ids = torch.as_tensor(b.pages.owned[slot][:n], device="cuda").long()
        held = {n: b.cache[n][:, ids].cpu() for n in kv.pages}
        held_rows = {n: tree_map(lambda t: t[:, slot].cpu(), b.cache[n])
                     for n in kv.rows}
        for h, k in zip(tree_leaves(held) + tree_leaves(held_rows),
                        tree_leaves(kv.pages) + tree_leaves(kv.rows)):
            if not torch.equal(bits(torch, h), bits(torch, k)):
                fail(f"{arch} request {req.rid}: an installed page or row "
                     f"differs from its harvest")
        installed.append(req.rid)

    def recording(req, slot):
        if req.kv_seed is None:
            prefilled.append((req.rid, len(req.prompt)))
        admit(req, slot)
    b._admit_migrated, b._admit = read_back, recording
    fins, launches_b = counted(lambda: b.run(conts), b)
    st = b.stats()
    if st["migrated_admits"] != len(harvested) or set(installed) != harvested:
        fail(f"{arch} drain: migrated_admits {st['migrated_admits']}, "
             f"installs {sorted(installed)}, harvested {sorted(harvested)}")
    if {rid for rid, _ in prefilled} & harvested:
        fail(f"{arch} drain: a harvested request was prefilled again")
    want_prefill = sum(len(c.prompt) for c in conts if c.kv_seed is None)
    if st["prefill_tokens"] != want_prefill:
        fail(f"{arch} drain: the second engine prefilled "
             f"{st['prefill_tokens']} tokens, want {want_prefill}")
    out = {f.rid: f for f in a.finished}
    for f in fins:
        out[f.rid] = policy.stitch(f)
    stitched = [out[r.rid] for r in reqs]
    for f, r in zip(stitched, reqs):
        if len(f.tokens) != r.max_new_tokens:
            fail(f"{arch} drain: request {r.rid} finished with "
                 f"{len(f.tokens)} tokens, budget {r.max_new_tokens}")
    saved = st["migrated_tokens_saved"]
    share = same_share(stitched, ample)
    print(f"drain [{card}]: {arch} drained after {DRAIN_TICKS} ticks: "
          f"{len(harvested)} slots harvested and installed bit-equal, "
          f"{len(conts) - len(harvested)} re-admitted without KV; second "
          f"engine migrated_admits={st['migrated_admits']} "
          f"migrated_tokens_saved={saved} prefill_tokens="
          f"{st['prefill_tokens']}; every request at its full budget, "
          f"stitched tokens equal to the run without the drain {share:.3f}; "
          f"launches before the drain {launches_a}, after {launches_b}")
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "drain_ticks": DRAIN_TICKS,
            "harvested": len(harvested), "launches_before": launches_a,
            "launches_after": launches_b, "stats": st,
            "same_token_share": share}


# ---------------------------------------------------------------------------
# phase 4c: the MoE family and deepseek-7b
# ---------------------------------------------------------------------------
def tick_bytes(cfg, params, st):
    """Bytes a decode tick must move at least: every weight the tick
    reads once (all experts: at decode the capacity dispatch runs every
    expert's C slots, routed or not; not the audio encoder's or the vlm
    projector's, which only an admit reads), the embedding's SLOTS rows
    rather than its table, the K/V of the pages in use at the run's mean
    pool occupancy, and the per-slot rows of the slots in use: audio's
    cross-K/V read, the RWKV state read and written."""
    from repro_torch.models.common import tree_leaves
    emb = params["embed"]
    weights = sum(t.numel() * t.element_size()
                  for k, v in params.items()
                  if k not in ("enc_blocks", "enc_final_norm", "vproj")
                  for t in tree_leaves(v))
    weights += (SLOTS - emb.shape[0]) * emb.shape[1] * emb.element_size()
    L, kvb = cfg.num_layers, 2 * cfg.num_kv_heads * cfg.head_dim * 2
    slots = st["occupancy"] * SLOTS
    if cfg.arch_type == "ssm":
        H, K = cfg.rwkv_heads, cfg.rwkv_head_dim
        kv = 2 * slots * L * (H * K * K * 4 + 2 * cfg.d_model * 2)
    else:
        kv = st["pool_occupancy"] * st["num_pages"] * PAGE * L * kvb
    if cfg.arch_type == "audio":
        kv += slots * L * cfg.encoder_seq * kvb
    return weights, kv


def describe(cfg):
    """The model's widths, for the phase 4c / 4d lines."""
    if cfg.arch_type == "moe":
        return (f"{cfg.num_experts} experts of {cfg.expert_d_ff} top-"
                f"{cfg.top_k} cf {cfg.capacity_factor}"
                + (f" + dense residual {cfg.dense_residual_d_ff}"
                   if cfg.moe_dense_residual else ""))
    out = f"d_ff {cfg.d_ff} {cfg.activation}"
    if cfg.arch_type == "ssm":
        out += (f", RWKV6: {cfg.rwkv_heads} heads of {cfg.rwkv_head_dim}, "
                f"decay LoRA {cfg.rwkv_decay_lora}")
    if cfg.arch_type == "audio":
        out += (f", encoder {cfg.num_encoder_layers} layers over "
                f"{cfg.encoder_seq} frames")
    if cfg.arch_type == "vlm":
        out += f", {cfg.num_patches} patches of 1024 prefixed"
    return out


def rwkv_state_check(torch, cfg, params, MD, reqs):
    """The ssm family runs no kernel; its gate holds one prompt's prefill
    (the WKV recurrence over the whole prompt, its projections as S-row
    GEMMs) against the same prompt fed token by token (1-row products).
    Both round the same bf16 products, in GEMMs of other shapes, so a
    rounded output may differ by a bf16 step (2^-8 relative):
    - each layer alone, on the prefill path's own input to it: the block
      over the prompt against the block token by token from a zero
      state; each state leaf (wkv fp32, tm and cm bf16) within the bf16
      kernel tolerance TOL of its largest entry;
    - the whole model, token by token through decode_step: the last
      logits within LOGIT_TOL x max(1, max|logit|), as phase 4 holds
      the kernel paths, and every layer's state within RWKV_PATH_TOL of
      its largest entry (the layers' differences compound through 24
      layers and the prompt's tokens: 0.048 on an H100 at 700 W)."""
    from repro_torch.models import rwkv as RW
    from repro_torch.models.common import torch_dtype, tree_map
    p = torch.as_tensor(reqs[0].prompt, device="cuda")[None].int()
    S, names = p.shape[1], ("wkv", "tm", "cm")

    def rel(a, b):
        return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)

    x = params["embed"][p.long()].to(torch_dtype(cfg.compute_dtype))
    alone = {n: (0.0, 0) for n in names}
    for i in range(cfg.num_layers):
        lp = tree_map(lambda t: t[i], params["blocks"])
        y, st = RW.rwkv_block(lp, x, cfg)
        sd = {n: torch.zeros_like(t) for n, t in st.items()}
        for t in range(S):
            _, sd = RW.rwkv_block(lp, x[:, t:t + 1], cfg, state=sd)
        for n in names:
            e = rel(sd[n], st[n])
            if not e <= TOL["bfloat16"]:
                fail(f"rwkv layer {i} alone: state {n} {e} of its largest "
                     f"entry apart (> {TOL['bfloat16']})")
            alone[n] = max(alone[n], (e, i))
        x = y
    lp, _, cp = MD.forward(params, cfg, p, return_cache=True)
    cache = MD.init_cache(cfg, 1, 1, "cuda")
    for t in range(S):
        ld, cache = MD.decode_step(params, cfg, p[:, t:t + 1], t, cache)
    err, scale = hold_logits("rwkv prefill vs token-by-token",
                             ld[0, 0], lp[0, -1])
    path = {}
    for n in names:
        errs = [rel(a, b) for a, b in zip(cache[n], cp[n])]
        worst = max(range(len(errs)), key=errs.__getitem__)
        if not errs[worst] <= RWKV_PATH_TOL:
            fail(f"rwkv state {n} at layer {worst}: {errs[worst]} of its "
                 f"largest entry apart (> {RWKV_PATH_TOL})")
        path[n] = {"rel_err_max": errs[worst], "layer": worst}
    return {"prompt": S, "logits_max_abs_err": err, "logit_scale": scale,
            "greedy_same": int(ld[0, 0].argmax()) == int(lp[0, -1].argmax()),
            "state_layer_alone": {n: {"rel_err_max": e, "layer": i}
                                  for n, (e, i) in alone.items()},
            "state_whole_path": path}


def family_phase(torch, card, ops, MD, SS, ServeEngine, Request,
                 profile=False, family=FAMILY, phase="4c"):
    """Phase 4c (the MoE family and deepseek-7b) or 4d (the last
    families): each model at full width, or at its published widths with
    its depth cut, one after another (each one's params freed before the
    next is drawn), serving phase 4's stream through the paged engine
    (the dense one for the ssm family) with the kernels on: launch counts
    exact, every request at its full budget, tokens/s, ticks, occupancy,
    peak device memory, ms a decode tick against its bytes bound and ms
    an admit (a synchronize after each); then the kernel path against the
    plain path (routing flips counted for the MoE models, the logits held
    on the kernel path's expert choices), or for the ssm family its
    prefill against its token-by-token decode."""
    import gc
    from repro_torch.models.config import param_count
    out = []
    t_phase = time.perf_counter()
    # earlier phases' engines sit in reference cycles (their wrapped
    # admits) with their models' params: free them first, so that the
    # peak memory below is this phase's own
    gc.collect()
    torch.cuda.empty_cache()
    for arch, depth in family:
        t_model = time.perf_counter()
        cfg = kernel_cfg(arch)
        full_layers, (full, _) = cfg.num_layers, param_count(cfg)
        if depth:
            cfg = cfg.with_(num_layers=depth)
        total, active = param_count(cfg)
        t0 = time.perf_counter()
        params = MD.init_model(cfg, torch.Generator(device="cuda")
                               .manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        reqs, fins, launches, st, wall, _ = serve(
            torch, cfg, params, ops, ServeEngine, Request, split_ticks=True)
        weights, kv = tick_bytes(cfg, params, st)
        bound_ms = 1e3 * (weights + kv) / PEAK_BYTES
        tick_ms = 1e3 * st["tick_s"].get("decode", 0.0) / st["decode_ticks"]
        admit_ms = (1e3 * st["tick_s"].get("prefill", 0.0)
                    / st["prefill_ticks"])
        tps = st["generated_tokens"] / wall
        cut = (f", depth cut to {depth} of {full_layers} layers (its "
               f"{full / 1e9:.1f}B params at full depth do not fit one "
               f"card)" if depth else "")
        pool = (f"pool_occupancy={st['pool_occupancy']:.3f}, "
                if "pool_occupancy" in st else "dense engine, ")
        print(f"family serve [{card}]: {arch} {total / 1e9:.2f}B params "
              f"({active / 1e9:.2f}B active) bf16, {cfg.num_layers} layers"
              f"{cut}, d_model {cfg.d_model}, {cfg.num_heads}/"
              f"{cfg.num_kv_heads} heads of {cfg.head_dim} (G "
              f"{cfg.num_heads // cfg.num_kv_heads}), {describe(cfg)}; "
              f"params drawn in "
              f"{init_s:.1f} s; {SLOTS} slots, {REQUESTS} requests: "
              f"{st['generated_tokens']} tokens in {wall:.2f} s = "
              f"{tps:.1f} tok/s, admits={st['prefill_ticks']} "
              f"decode_ticks={st['decode_ticks']} "
              f"occupancy={st['occupancy']:.3f} "
              f"{pool}peak memory "
              f"{st['peak_mem_gb']:.2f} GB; a decode tick {tick_ms:.2f} ms "
              f"(bound {bound_ms:.2f} ms: {weights / 1e9:.2f} GB of "
              f"weights + {kv / 1e9:.3f} GB of K/V and state at "
              f"{PEAK_BYTES / 1e12:.2f} TB/s), an admit {admit_ms:.2f} ms; "
              f"launches={launches}")
        prof = None
        if profile:
            prof = profile_serve(torch, cfg, params, ServeEngine, Request)
            print(f"split [{card}] {arch}: {json.dumps(prof['split'])}")
            print_trace(card, f"trace {arch}", prof["trace"])
        if cfg.arch_type == "ssm":
            plain = rwkv_state_check(torch, cfg, params, MD, reqs)
            print(f"prefill vs token-by-token decode [{card}] {arch}: "
                  f"{json.dumps(plain)}")
        else:
            plain = compare_plain_paths(torch, cfg, params, MD, SS, reqs)
            print(f"kernel vs plain path [{card}] {arch}: "
                  f"{json.dumps(plain)}")
        if "routing" in plain:
            r = plain["routing"]
            print(f"routing [{card}] {arch}: {r['differ']} of {r['pairs']} "
                  f"(token, layer) expert choices differ between the kernel "
                  f"and plain paths ({r['share']:.4f}); prefill tokens "
                  f"routed apart at some layer {r['prefill']['tokens_differ']}"
                  f" of {r['prefill']['tokens']}, first at layers "
                  f"{r['prefill']['first_differ_by_layer']}; logits held "
                  f"on the kernel path's choices")
            z, c = r["layer0"], r["sdpa_control"]
            print(f"routing [{card}] {arch} layer 0 (same input on both "
                  f"paths): flash vs plain attention max|err| "
                  f"{z['attention_max_abs_err']:.3g} (of max "
                  f"{z['attention_max_abs']:.3g}); {z['flipped']} of "
                  f"{z['tokens']} tokens flipped, their top-k gap at most "
                  f"{z['gap_flipped_max']} ({z['gap_over_2change_max']:.3f}"
                  f" x twice their probabilities' change; all tokens' "
                  f"median gap {z['gap_all_median']:.3g}, median change "
                  f"{z['change_all_median']:.3g}); control, plain path "
                  f"with SDPA against the plain path: {c['differ']} of "
                  f"{c['pairs']} prefill choices differ "
                  f"({c['differ'] / c['pairs']:.4f}, kernel "
                  f"{r['prefill']['differ'] / r['prefill']['pairs']:.4f}), "
                  f"{c['layer0']['flipped']} tokens flipped at layer 0")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        secs = time.perf_counter() - t_model
        out.append({"arch": arch, "layers": cfg.num_layers,
                    "full_layers": full_layers, "params": total,
                    "active_params": active, "full_depth_params": full,
                    "launches": launches, "init_s": init_s,
                    "stats": dict(st, wall_s=wall, tok_s=tps),
                    "decode_tick_ms": tick_ms, "admit_ms": admit_ms,
                    "tick_bound_ms": bound_ms, "tick_weight_bytes": weights,
                    "tick_kv_bytes": kv, "plain_paths": plain,
                    "profile": prof,
                    "seconds": secs})
        print(f"family [{card}]: {arch} took {secs:.1f} s")
    print(f"family [{card}]: phase {phase} took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


def swa_phase(torch, card, ops, MD):
    """qwen3-0.6b's sliding-window variant (shape_plan's long_500k,
    window 4096): a SWA_PROMPT-token prompt prefilled through flash with
    the window (one launch a layer), the ring of `window` slots built
    from its cache as the reference's test builds it, then SWA_STEPS
    teacher-forced decode steps on the ring (no kernel: a dense ring), each
    step's logits held against the plain path's windowed forward of the
    whole SWA_PROMPT + SWA_STEPS tokens (LOGIT_TOL x max(1, max|logit|)),
    the prefill's last logits too."""
    import numpy as np
    from repro_torch.configs import shape_plan
    t0 = time.perf_counter()
    cfg = shape_plan(ARCH, "long_500k").with_(use_flash_kernel=True,
                                              use_paged_kernel=True)
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    S, T, W = SWA_PROMPT, SWA_STEPS, cfg.sliding_window
    toks = torch.as_tensor(np.random.RandomState(5).randint(
        0, cfg.vocab_size, size=(1, S + T)), device="cuda").int()
    torch.cuda.synchronize()
    ops.reset_launches()
    lk, _, cache = MD.forward(params, cfg, toks[:, :S], return_cache=True)
    ring = MD.init_cache(cfg, 1, S, "cuda")
    if ring["k"].shape[2] != W:
        fail(f"{cfg.name}: the ring holds {ring['k'].shape[2]} slots, "
             f"want the window {W}")
    idx = torch.arange(S - W, S, device="cuda")
    for n in ring:
        ring[n][:, :, idx % W] = cache[n][:, :, idx]
    del cache
    steps = []
    for t in range(T):
        lg, ring = MD.decode_step(params, cfg, toks[:, S + t:S + t + 1],
                                  S + t, ring)
        steps.append(lg[0, 0])
    torch.cuda.synchronize()
    launches = {n: getattr(ops, n).launches for n in
                ("flash_attention", "paged_attention", "ssd_scan")}
    want = {"flash_attention": cfg.num_layers, "paged_attention": 0,
            "ssd_scan": 0}
    if launches != want:
        fail(f"{cfg.name}: launches {launches}, want {want}")
    ref, _, _ = MD.forward(params, plain_cfg(cfg), toks)
    pre_err, pre_scale = hold_logits(f"{cfg.name} prefill", lk[0, -1],
                                     ref[0, S - 1])
    errs = [hold_logits(f"{cfg.name} ring decode step {t}", steps[t],
                        ref[0, S + t])[0] for t in range(T)]
    same = sum(int(steps[t].argmax()) == int(ref[0, S + t].argmax())
               for t in range(T))
    secs = time.perf_counter() - t0
    res = {"arch": cfg.name, "window": W, "prompt": S, "steps": T,
           "launches": launches, "prefill_max_abs_err": pre_err,
           "logit_scale": pre_scale, "decode_max_abs_err": max(errs),
           "greedy_same": same, "seconds": secs}
    print(f"swa [{card}]: {cfg.name} window {W}: {S}-token prompt through "
          f"flash, {T} decode steps on a ring of {W} slots, every step's "
          f"logits held against the windowed forward of {S + T} tokens: "
          f"{json.dumps(res)}")
    del params, ring, ref
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the full results, chip_smoke.json")
    ap.add_argument("--profile", action="store_true",
                    help="also split each serve run into admits and decode "
                         "ticks and trace a window of it, and trace one "
                         "train step")
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
    from repro_torch.kernels import nat_compress as NC
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref as TR
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.config import param_count
    from repro_torch.serving import Request, ServeEngine

    t_start = time.perf_counter()
    card = card_line()                                          # phase 1
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()                                    # phase 2
    reports = build.build(["flash_attention", "paged_attention",
                           "nat_compress", "ssd_scan"])
    build_s = time.perf_counter() - t0
    print(f"build [{card}]: {build_s:.1f} s")
    for name, rep in reports.items():
        entry = ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_of(line)
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}")

    rows = []                                                   # phase 3
    errs = check_kernels(torch, FA, PA, rows)
    errs.update(check_ssd(torch, SS, TR, rows))
    for r in rows:
        print(f"check [{card}] {r[0]} {r[1]} {r[2]} "
              f"{'' if r[3] is None else r[3] + ' '}max|err|={r[4]:.3g}")
    nc_rows = []
    errs.update(check_nc(torch, NC, nc_rows))
    for r in nc_rows:
        print(f"check [{card}] nc_pack/nc_unpack {r['dtype']} n={r['n']} "
              f"(below 2^-69: {r['below_range']}, at or above 2^57: "
              f"{r['above_range']}): codes and values bit-identical")

    paths, ample = [], {}
    for arch in (ARCH, HYBRID):                                 # phase 4
        rec, ample[arch] = serve_path(torch, card, arch, ops, MD, SS,
                                      ServeEngine, Request, args.profile)
        paths.append(rec)
    spec = spec_phase(torch, card, ops, MD)                     # phase 4b
    drains = [drain_phase(torch, card, arch, ops, MD, ample[arch])
              for arch in (ARCH, HYBRID)]
    family = family_phase(torch, card, ops, MD, SS, ServeEngine,  # 4c
                          Request, args.profile)
    last = family_phase(torch, card, ops, MD, SS, ServeEngine,    # 4d
                        Request, args.profile, family=LAST, phase="4d")
    swa = swa_phase(torch, card, ops, MD)

    mid = [PLEN[0] + (PLEN[1] + GEN[1] - PLEN[0]) * i // SLOTS
           for i in range(SLOTS)]
    timing = {}                                                 # phase 5
    for arch, sfx in ((ARCH, ""), (HYBRID, f"@{HYBRID}")):
        timing["flash_attention" + sfx] = time_flash(torch, FA, HEADS[arch])
        timing["paged_attention" + sfx] = time_paged(torch, PA, HEADS[arch],
                                                     mid)
    timing["paged_attention@verify"] = time_paged_verify(torch, PA,
                                                         HEADS[TARGET], mid)
    for arch, _ in FAMILY:
        timing[f"flash_attention@{arch}"] = time_flash(torch, FA,
                                                       HEADS[arch])
        timing[f"paged_attention@{arch}"] = time_paged(torch, PA,
                                                       HEADS[arch], mid)
    # phase 4d's: whisper's encoder and its cross-attention at a mid
    # prompt, positions inside its 448-token decoder; phi-3's prefill of
    # 576 patches + 512 tokens, its positions past the patches
    W = HEADS[WHISPER]
    timing[f"flash_attention@{WHISPER}"] = time_flash(
        torch, FA, W, S=1500, causal=False)
    timing[f"flash_attention@{WHISPER}:cross"] = time_flash(
        torch, FA, W, S=192, T=1500, causal=False)
    timing[f"paged_attention@{WHISPER}"] = time_paged(
        torch, PA, W, [64 + (448 - 64) * i // SLOTS for i in range(SLOTS)],
        cache_len=448)
    vcfg = kernel_cfg(VLM)
    timing[f"flash_attention@{VLM}"] = time_flash(
        torch, FA, HEADS[VLM], S=vcfg.num_patches + PLEN[1])
    timing[f"paged_attention@{VLM}"] = time_paged(
        torch, PA, HEADS[VLM], [vcfg.num_patches + p for p in mid],
        cache_len=stream_cache_len(vcfg))
    timing[f"flash_attention@{NEMOTRON}"] = time_flash(torch, FA,
                                                       HEADS[NEMOTRON])
    timing[f"paged_attention@{NEMOTRON}"] = time_paged(
        torch, PA, HEADS[NEMOTRON], mid)
    # beyond the serve paths' prompts (at most 512): where flash stands
    # against SDPA on longer prefills
    timing["flash_attention S=1024"] = time_flash(torch, FA, HEADS[ARCH],
                                                  S=1024)
    timing["ssd_scan"] = time_ssd(torch, SS)
    for name, t in timing.items():
        lib = ("none" if t["library_ms"] is None else
               f"{t['library']} {t['library_ms']:.4f} ms")
        print(f"time [{card}] {name} {t['shape']}: kernel {t['ms']:.4f} ms "
              f"(a call {t['call_ms']:.4f} ms), "
              f"plain {t['plain_ms']:.4f} ms, library {lib}, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    train_cfg = get_config(ARCH)          # bf16, block remat, flags off
    total, _ = param_count(train_cfg)
    nc_t = time_nc(torch, NC, [d.shape for d in
                               tree_leaves(MD.model_descs(train_cfg))])
    for scope, t in nc_t.items():
        for name in ("nc_pack", "nc_unpack"):
            k = t[name]
            print(f"time [{card}] {name} {scope} ({t['elements']} elements, "
                  f"{t['launches']} launches): kernel {k['ms']:.4f} ms, "
                  f"plain {k['plain_ms']:.4f} ms, library none, "
                  f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})")

    tr = train_phase(torch, train_cfg, ops, NC, profile=args.profile)
    print(f"train [{card}]: {ARCH} {total / 1e6:.1f}M params bf16, "  # phase 6
          f"remat={train_cfg.remat}, batch {tr['batch']} x seq {tr['seq']}, "
          f"{tr['steps']} timed steps: {tr['ms_per_step']:.1f} ms/step, "
          f"{tr['tok_s']:.0f} tokens/s, peak memory "
          f"{tr['peak_mem_gb']:.2f} GB, launches {tr['launches']}")
    print(f"train [{card}]: losses {[round(x, 4) for x in tr['losses']]}")
    print(f"train split [{card}]: {json.dumps(tr['split'])}")
    if tr["trace"]:
        print_trace(card, "train trace", tr["trace"])
    print(f"train kernel vs plain compression [{card}]: {tr['n_leaves']} "
          f"leaves, {tr['grad_elements']} gradient elements "
          f"{json.dumps(tr['grad_range'])}: compressed gradients, params "
          f"and moments bit-identical")

    # launches by path: each counted from zero over its own main-path run
    by_path = {f"{p['arch']} serve": p["launches"]
               for p in paths + family + last}
    by_path[f"{swa['arch']} prefill"] = swa["launches"]
    by_path.update({f"{p['arch']} serve, tight pool": p["tight_pool"]
                    ["launches"] for p in paths if p["tight_pool"]})
    by_path.update({p: run["launches"] for p, run in spec["runs"].items()})
    for d in drains:
        by_path[f"{d['arch']} drain"] = d["launches_before"]
        by_path[f"{d['arch']} migrated"] = d["launches_after"]
    by_path[f"{ARCH} train"] = {n: tr["launches"][n]
                                for n in ("nc_pack", "nc_unpack")}
    timing.update(nc_pack=nc_t["embed"]["nc_pack"],
                  nc_unpack=nc_t["embed"]["nc_unpack"])
    kernels = []
    for name, src, replaces in (
            ("flash_attention", "flash_attention",
             "src/repro/kernels/flash_attention.py:77"),
            (f"flash_attention@{HYBRID}", "flash_attention",
             "src/repro/kernels/flash_attention.py:77"),
            ("paged_attention", "paged_attention",
             "src/repro/kernels/paged_attention.py:77"),
            (f"paged_attention@{HYBRID}", "paged_attention",
             "src/repro/kernels/paged_attention.py:77"),
            ("paged_attention@verify", "paged_attention",
             "src/repro/kernels/paged_attention.py:77"),
            *((f"{k}@{arch}", k, f"src/repro/kernels/{k}.py:77")
              for arch, _ in FAMILY + LAST[1:]
              for k in ("flash_attention", "paged_attention")),
            (f"flash_attention@{WHISPER}:cross", "flash_attention",
             "src/repro/kernels/flash_attention.py:77"),
            ("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:69"),
            ("nc_pack", "nat_compress", "src/repro/kernels/nat_compress.py:56"),
            ("nc_unpack", "nat_compress",
             "src/repro/kernels/nat_compress.py:80")):
        # "kernel@model": the same kernel timed at that model's shapes,
        # with the launches of that model's runs ("@model:cross": at
        # another of its shapes); "@verify": at the verify shape, with
        # the speculative runs' launches
        kernel, _, at = name.partition("@")
        at = at.partition(":")[0]
        t = timing[name]
        paths_n = {p: n[kernel] for p, n in by_path.items()
                   if n.get(kernel) and (
                       not at or p.startswith(at)
                       or (at == "verify" and " spec " in p))}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": sum(paths_n.values()),
            "launches_by_path": paths_n, "shape": t.get("shape"),
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    elapsed = time.perf_counter() - t_start
    result = {"card": card, "build_s": build_s, "elapsed_s": elapsed,
              "checks": rows, "serve": paths, "spec": spec,
              "family": family, "last": last, "swa": swa,
              "drain": drains, "nc_checks": nc_rows,
              "timing": dict(timing, nc=nc_t),
              "train": tr}
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
