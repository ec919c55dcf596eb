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
     edges, S < T, windows and full masking, at the edges of its plan
     (G 7 and 12 packed into 64 / 128 rows off whole positions, windows
     under packing, keys split over blocks at T >> S, S > T with rows
     that see no key and must emit 0), and the paged kernel with
     positions at the edges of its planned splits (and a row at pos -1,
     which must emit 0), every group and page size, stale pages poisoned
     (the output must not change by a bit) and each call twice (the two
     outputs must be bit-identical), and at the verify shape (8 table rows
     of 4 candidate query rows each, every slot's pages read once, also
     held against the same rows through the repeated table), G 7 and 12
     with 4 rows a table row (28 and 48 rows a block), groups past 64
     rows (G 12 with 6 rows, G 1 with 70: two chunks of rows) and page
     sizes 1-32 at the edges of the plan's stages and splits, and 300 and
     512 (sub-pages within a TMA box); both
     attention kernels at
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
     plain versions' (flags off); the same stream once more under a
     `repro_torch.obs` Recorder: the greedy streams equal the unrecorded
     run's, one serve.first_token and one request span a request, one
     serve.admit an admit, the trace file parsed back with every event;
     admit -> first token and ms an output token (p50, p99) and tokens/s
     with and without recording printed; then serve zamba2-1.2b at full width
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
     qwen3-0.6b drafting (k 3, its weights from another seed, its depth
     cut from 28 to 4 layers at its widths); launch counts exact (an
     admit: 28 flash, and 4 more for the model draft's prefill; a verify
     round: 28 paged; the draft's dense decode scan: none), every
     emitted token a near-argmax of a teacher-forced plain forward of
     the target over prompt + emitted (within 5e-2 x max(1,
     max|logit|) of its row's maximum); the share of tokens equal to the
     plain run's reported, not gated; then that 4-layer draft drafting
     for itself on 4 requests, with at least one round that accepts all
     k.  Then qwen3-0.6b and zamba2-1.2b each serve phase 4's stream,
     drained after 11 ticks, the requests re-admitted through
     ServingDrainReadmit onto a second engine: every harvested page and row
     read back bit-equal after its install, migrated_admits equal to the
     harvested count, no prefill of a harvested prefix, every request at
     its full budget, launch counts exact (no flash, no ssd_scan for a migrated admit);
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
  4d. the last families, as 4c: rwkv6-1.6b (d_model 2048, its depth cut
     from 24 to 6 layers for time; the dense engine, no kernel; its gate
     the prefill's recurrent state and last logits against the same prompt
     fed token by token), whisper-tiny (4 + 4 layers over 1500 frames a
     request drawn from a seed, its stream cut to the 448-token decoder:
     prompts 64-320; launches exact: 12 flash an admit, 4 encoder, 4 self, 4
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
     paged at each model's pool), flash also at qwen3-0.6b's prefills of
     1024 and 8192 tokens (the latter bound by operations): card time
     from CUDA-graph replays
     (`device_ms`: these kernels take less time than the host needs to
     issue them), and the eager call time beside it; each paged line
     names its plan (rows a block, tiles, pages a stage, stages, splits);
  6. train qwen3-0.6b at full width (28 layers, bf16, block remat, AdamW,
     warmup-cosine, natural-compressed gradients, the synthetic bigram
     pipeline) at batch 2 x seq 4096: one warm-up step, then timed steps
     with the launch counters zeroed just before and read just after
     (14 nc_pack and 14 nc_unpack launches a step, one per gradient leaf;
     no attention kernel); then one step's split into forward+backward,
     compression and optimizer, and the same gradients compressed by the
     kernels and by the plain versions, which must agree bit for bit, and
     so must the parameters each update gives (the train step is the
     launcher's: params and moments updated in place); then the same
     loop saves through AsyncCheckpointer and steps
     on while the writer works: after wait() the restore equals the saved
     params and moments bit for bit (ckpt.snapshot ms, the writer's ms, a
     step with the save in flight against one without); then zamba2-1.2b
     (batch 2 x 4096), rwkv6-1.6b (2 x 512 at 6 of its 24 layers: its
     recurrence runs a token at a time), whisper-tiny (8 x 448) and
     phi-3-vision-4.2b (1 x 2048 after 576 patches) train at full width
     through the launcher, one after another: a warm-up step and 2 timed
     ones read from the train.step spans, nc launches exactly leaves x
     steps, finite losses, and one step's compressed gradients through the kernels and the
     plain versions bit-identical, leaf by leaf, and their global norms
     equal; the raw gradients' non-finite elements are counted (phi-3's
     zero-patch prefix overflows at depth: ROADMAP queue 3); then
     phi-3-vision-4.2b once more on patches drawn from a seed, fed through
     the batch's `extra_embeds` (fresh weights, 4 AdamW steps on one
     batch): every gradient norm finite, the loss falling;
  7. qwen3-0.6b through `core/data_parallel` (S-SGD, local SGD, EASGD),
     the reshard and stacked save of its params on the card, and the
     Coordinator over ProcTransport worker processes;
  8. elastic training of qwen3-0.6b at full width, its depth cut to 4
     layers, through `repro_torch.launch.train --elastic --layers 4`: sync
     over 4 workers (batch 4 x 2048, compressed gradients, a save every 4
     steps, 2 kept) with worker 1 killed at wall 6: step 4 restored (2 steps
     lost), the restored params and moments bit-equal to the save read
     back, final_alive (0, 2, 3), 8 finite losses, nc_pack / nc_unpack launched exactly 14
     leaves x the 10 steps run and nothing else, one step's compressed
     gradients bit-identical to the plain path's (ms a step, the save
     pauses, the restore time); local_sgd and async_ps over 2 workers of
     1024 tokens for 3 steps with a death at wall 2: no step lost,
     final_alive (0,),
     finite losses (peak memory); `run_elastic` on the card against the
     CPU in all five modes (transitions, recoveries, sim_time, goodput
     equal, losses within 1e-5) and a sync run over ProcTransport equal to
     its SimTransport run; the checkpoints deleted after;
  9. the serving fleet: `repro_torch.launch.serve --replicas 3 --paged`
     with qwen3-0.6b at full width (one param set, one ServeProgram) on
     phase 4's request shapes, failure-free, then with replica 1 killed
     mid-stream at a wall tick where each of its requests has emitted:
     every request finished once with its full budget, one drain, every
     in-flight request re-admitted by KV migration (migrated_admits ==
     readmitted), each install read back bit-equal, no preemption,
     flash / paged launches one a layer an admit / a decode tick summed
     over the fleet's engines (the dead one's included), the stitched
     streams equal to the failure-free run's (or, past a bf16 near-tie,
     the share reported and the comparison gated in fp32 at 4 layers);
     then `--hedged` with replica 2 hung: at least one hedge, each request
     delivered once, every hedge resolved (fleet tokens/s, wall ticks,
     peak memory);
 10. model parallelism and the mesh on a world of one (an NCCL group of
     one rank, `make_device_mesh(1, 1)`), qwen3-0.6b at full width: one
     train step at phase 6's shape under each of the launcher's envs
     (dp, tp, dp_tp, fsdp) from the same state as the plain unsharded
     step, parameters, moments, loss and gnorm bit-equal and nc launches
     one a leaf, a second step's ms beside phase 6's; a tp prefill
     through flash bit-equal to the unsharded one (28 flash launches);
     DDG over the 28 layers as 4 modules of 7 for 12 ticks (JAX's fill
     sequence of active modules, finite and falling losses) and K = 1 at
     2 layers bit-equal to sequential_step; pipeline_apply at S = 1 over
     the 28 blocks bit-equal to sequential_apply; then at qwen3-0.6b's
     widths cut to 4 of its 28 layers: the dp_tp mesh state after a
     compressed AdamW step saved blocking and through AsyncCheckpointer,
     byte-identical to the save of the plain state at the same step, its
     restore into the mesh layout bit-equal leaf for leaf with the same
     placements, and a step from the restore bit-equal to the step from
     the unbroken state; one Adafactor step under dp_tp bit-equal to the
     plain Adafactor step, parameters and statistics; 10g: phase 8's
     runs again through `launch.train._train(args, mesh)` with --elastic
     on the 1x1 mesh, phase 8's kills: over --transport proc sync with
     --compress-grads --async-ckpt and local_sgd, async_ps over sim:
     recoveries, transitions, final_alive and the restored step phase
     8's, losses bit-equal, nc launches one a gradient leaf a step run;
     10h: phase 9's killed run through `serve(... "--replicas",
     "--transport", "proc", "--paged" ..., mesh=mesh)`: every request
     once at its full budget, one drain, the streams phase 9's, launches
     exact, tokens/s beside phase 9's;
 11. deep RL (no kernel on this path: every launch count stays put):
     `repro_torch.launch.rl` at its defaults on the card under sim, then
     actor 1 killed at wall 15 under sim and under `--transport proc`
     (losses, final params and transitions of the two equal float for
     float, goodput exactly 1 - (steps - 15) / (actors * steps) of the
     failure-free run's, the obs events carrying the JAX package's names
     on its lanes); GORILA, Ape-X, A3C, IMPALA and DPPO one round each on
     the card and on the CPU from the same state and host-drawn draws
     (params within 2e-5, env states equal); IMPALA and A3C over 4096
     workers x hidden 1024 and GORILA over 1024 actors with a 2^20-slot
     replay (ms a round, env steps/s, finite losses);
 12. classic ML on data drawn on the card: distributed k-means over
     8 x 2^20 x 64 (k 64, 20 iterations) equal to the centralized run and
     its inertia not rising, `svm_dist_gradient` over 8 x 2^18 x 256 equal
     to `svm_centralized`, `adaboost_dist_full` over 8 x 2^16 x 64 picking
     the centralized stumps, DPSVM over 8 x 2^14 x 64 and fuzzy c-means
     with Xie-Beni at k 2-8 over 8 x 2^16 x 16 (least at the 5 clusters
     drawn; ms an iteration beside x read once at 3.35 TB/s), then the
     distributed trainers at 1/64 of the rows on the card against the CPU;
 13. serving under a mesh, the dry run and the roofline: (a) phase 4's
     stream through `repro_torch.launch.serve --continuous --paged
     --data 1 --model 1` on an NCCL group of one rank (qwen3-0.6b at full
     width, the weights of phase 4's seed): the greedy streams equal
     phase 4's token for token, flash launches 28 an admit and paged 28
     a decode tick exactly, the k and v pools DTensors placed as
     `cache_pspecs(serve=True)` says; tokens/s and wall ms a decode
     tick beside phase 4's; the run takes --trace-out, and its trace
     holds one `request` span a request and the engine's `serve.*`
     events, by name, cat and count those of phase 4's recorded run;
     (b) `python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
     all --mesh single` as a subprocess with no card visible (started with
     phase 6, whose train steps leave the host's cores idle, and read
     here), on the (32, 8) mesh of a fake group of 256: every record ok or
     skipped, useful_ratio in (0, 1], each record's three terms (H100 SXM
     published peaks on counted work),
     bottleneck and bound printed; train_4k's temp below the card's
     80 GB (the vocab-parallel loss); (c) `launch/steps.cost_plan` of phase
     6's train step (qwen3-0.6b, 2 x 4096, AdamW, block remat; without the gradient
     compression phase 6 adds) on a fake (1, 1) mesh: its lower bound
     beside phase 6's measured ms a step, which must not beat it (share
     of the bound in the step at most 1.05).  Phase 1 checks first that
     this torch has `torch.testing._internal.distributed.fake_pg`.

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
# pairing), the draft's weights from another seed and its depth cut from
# 28 to DRAFT_LAYERS layers at its widths, for time: at full depth its
# k dense decode steps a round made the model-draft run take 77 s
TARGET, DRAFT_SEED, SPEC_K, DRAFT_LAYERS = "qwen3-1.7b", 7, 3, 4
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
# params do not fit one card, so its depth is cut (96 -> 4 layers);
# rwkv6-1.6b's is cut for time (24 -> RWKV_LAYERS layers, here and in
# phase 6): its WKV recurrence runs one token at a time, and its gate
# feeds a prompt token by token through every layer
RWKV, WHISPER, VLM, NEMOTRON = ("rwkv6-1.6b", "whisper-tiny",
                                "phi-3-vision-4.2b", "nemotron-4-340b")
RWKV_LAYERS = 6
LAST = ((RWKV, RWKV_LAYERS), (WHISPER, None), (VLM, None), (NEMOTRON, 4))
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
# the other families' train runs: (arch, batch, seq, layers if cut, the
# cut if any), one warm-up step and TRAIN_TIMED timed ones each.  rwkv6's
# WKV recurrence runs one token at a time (in the JAX package too), so
# its sequence is cut to 512 and its depth to RWKV_LAYERS; whisper's is
# its 448-token decoder context; phi-3's 2048 tokens follow its 576
# patches.
TRAIN_FAMILIES = (
    (HYBRID, 2, 4096, None, None),
    (RWKV, 2, 512, RWKV_LAYERS,
     f"seq cut from 4096 to 512 and depth from 24 to {RWKV_LAYERS} "
     f"layers: the WKV recurrence runs one token at a time"),
    (WHISPER, 8, 448, None, None),
    (VLM, 1, 2048, None, None))
TRAIN_TIMED = 2
# phase 7: data parallelism on qwen3-0.6b at full width.  (a) S-SGD over
# DP_W workers of 1 x DP_SEQ tokens (phase 6's 2 x 4096 split in two), a
# warm-up step and DP_TIMED timed ones; (b) the fp32 equivalence, 1 x
# EQ_SEQ a worker, SGD at EQ_LR, held to EQ_TOL of the largest update
# element; (c) local SGD and EASGD rounds, LOCAL_K steps of 1 x LOCAL_SEQ;
# (e) the coordinator driven for COORD_STEPS wall steps
DP_W, DP_SEQ, DP_TIMED = 2, 4096, 3
EQ_SEQ, EQ_LR, EQ_TOL = 512, 0.1, 1e-4
LOCAL_K, LOCAL_SEQ, LOCAL_LR = 2, 1024, 1e-2
COORD_STEPS = 6
# phase 6's phi-3-vision-4.2b run on patches drawn from a seed (ROADMAP
# queue 3's decision): PATCH_STEPS AdamW steps at peak PATCH_LR on one
# batch, its patches from seed PATCH_SEED on the card
PATCH_STEPS, PATCH_LR, PATCH_SEED = 4, 1e-3, 1234
# phase 8: elastic training of qwen3-0.6b at full width, its depth cut,
# through the launcher.  (a) sync: EL_W workers sharing a global batch of
# EL_BATCH x EL_SEQ, compressed gradients, a save every EL_CKPT_EVERY steps,
# EL_KEEP kept, worker 1 killed at wall EL_FAIL_AT; (b, c) local_sgd and
# async_ps on EL_LOCAL_W workers of EL_LOCAL_SEQ, worker 1 killed at
# EL_LOCAL_FAIL;
# (d) run_elastic on the card against the CPU in all five modes, on
# tests/test_elastic.py's single-failure trace (EL_SIM_FAIL of
# EL_SIM_STEPS)
EL_W, EL_BATCH, EL_SEQ, EL_STEPS = 4, 4, 2048, 8
# (a-c) train qwen3-0.6b's widths at EL_LAYERS of its 28 layers (the
# launcher's --layers), for time: at full depth they took 137 s; 8
# layers and 10 steps until 10g ran them again on the mesh
EL_LAYERS = 4
EL_CKPT_EVERY, EL_KEEP, EL_FAIL_AT = 4, 2, 6
EL_LOCAL_W, EL_LOCAL_BATCH, EL_LOCAL_SEQ = 2, 8, 1024
EL_LOCAL_STEPS, EL_LOCAL_FAIL = 3, 2
EL_SIM_STEPS, EL_SIM_FAIL = 60, 23
ELASTIC_MODES = ("sync", "local_sgd", "easgd", "async_ps", "ssp")
# phase 9: FLEET_REPLICAS replicas of qwen3-0.6b at full width on phase
# 4's request shapes; replica FLEET_VICTIM killed at the first wall tick
# from FLEET_MIN_WALL on at which every request on it has emitted and
# none waits in its queue (so each re-admits by KV migration); the
# hedged run hangs replica FLEET_HUNG.  If a bf16 near-tie parts the
# killed run's streams from the failure-free run's, the same comparison
# is gated in fp32 with the depth cut to FLEET_FP32_LAYERS
FLEET_REPLICAS, FLEET_VICTIM, FLEET_HUNG, FLEET_MIN_WALL = 3, 1, 2, 10
FLEET_FP32_LAYERS = 4
# phase 10: DDG over DDG_K modules on one batch of DDG_B x DDG_S tokens
# for DDG_TICKS ticks at SGD rate DDG_LR; pipeline_apply over a batch of
# PP_B x PP_S, also in PP_M microbatches
DDG_K, DDG_B, DDG_S, DDG_TICKS, DDG_LR = 4, 2, 1024, 12, 0.05
PP_B, PP_S, PP_M = 2, 1024, 2
# (e, f) the mesh state's save, restore and Adafactor step: qwen3-0.6b's
# widths at MESH_STATE_LAYERS of its 28 layers, phase 6's batch
MESH_STATE_LAYERS = 4
# phase 13b: the dry run's train_4k before the vocab-parallel loss
# (PERF.md, the dry run on the card's host): a chip's temp and bound
DRY_TRAIN_4K_BEFORE = {"temp_gb": 679.4, "bound_s": 0.886}
CARD_BYTES = 80e9
# phase 11: deep RL.  (a) `launch.rl` at its defaults (4 actors, 40
# rounds), then actor 1 killed at wall RL_KILL_AT under sim and under
# proc; (b) each architecture's round on the card and on the CPU over
# RL_CMP_W workers; (c) the rounds at a card-sized batch axis: RL_BIG_W
# workers (RL_BIG_ACTORS for GORILA, its replay RL_BIG_CAP slots sampled
# RL_BIG_BATCH at a time), hidden RL_BIG_HIDDEN, rollouts of 16,
# RL_TIMED timed rounds after one warm-up
RL_KILL_AT, RL_CMP_W = 15, 256
RL_BIG_W, RL_BIG_ACTORS, RL_BIG_CAP, RL_BIG_BATCH = 4096, 1024, 1 << 20, 4096
RL_BIG_HIDDEN, RL_TIMED = 1024, 5
# phase 12: classic ML at sizes users run, the data drawn on the card from
# CL_SEED: (name, workers, rows a worker, dims); the card-vs-CPU check
# runs the distributed trainers at 1/CL_SMALL of the rows
CL_KMEANS = (8, 1 << 20, 64)       # 2 GiB of fp32, k CL_K, CL_ITERS iters
CL_SVM = (8, 1 << 18, 256)         # 2 GiB, CL_SVM_STEPS steps
CL_BOOST = (8, 1 << 16, 64)        # 16 thresholds, CL_ROUNDS rounds
CL_DPSVM = (8, 1 << 14, 64)        # CL_HOPS hops, SV capacity CL_SV_CAP
CL_FUZZY = (8, 1 << 16, 16)        # k 2..8, CL_FUZZY_TRUE true clusters
CL_K, CL_ITERS, CL_SVM_STEPS, CL_ROUNDS = 64, 20, 300, 20
CL_HOPS, CL_SV_CAP, CL_FUZZY_TRUE, CL_FUZZY_STEPS = 8, 1024, 5, 25
CL_SEED, CL_SMALL = 2024, 64
KERNEL_NAMES = ("flash_attention", "paged_attention", "ssd_scan", "nc_pack",
                "nc_unpack")
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


def same_tree_bits(torch, a, b):
    """Two trees of tensors equal bit for bit (-0.0 and 0.0 differ), in
    dtype and shape too."""
    from repro_torch.models.common import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(torch, x), bits(torch, y))
        for x, y in zip(la, lb))


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
             (1, 65, 130, 14, 2, 64, True, None),        # G 7, S < T
             # the Hopper kernel's plan: G 7 and 12 packed into 64 / 128
             # rows with S off the block's positions, windows under
             # packing, key splits (T >> S), S > T (rows with no key)
             (1, 100, 100, 14, 2, 128, True, None),
             (1, 77, 77, 24, 2, 64, True, None),
             (2, 53, 53, 24, 2, 192, True, None),
             (1, 300, 300, 16, 2, 128, True, 50),
             (1, 700, 700, 14, 2, 192, True, 130),
             (1, 40, 2000, 12, 1, 64, True, None),
             (1, 33, 3000, 12, 1, 192, True, None),
             (1, 64, 4096, 8, 8, 128, False, None),
             (1, 300, 100, 14, 2, 128, True, None)]
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


# phase 3's S-row cases, (B, S, P, n_max, (Hq, Hk, dh)): the verify form
# at arctic-480b's and nemotron-4-340b's groups (G 7 and 12, S 4), and
# past 64 rows a group (nemotron at --spec-k 5, G 1 with 70 rows), G 12
# at dh 32 and G 7 at dh 96 with small pages, then page sizes 1-32 at the
# stage edges (one and four rows a table row), and pages past a TMA
# box's 256 rows (300 and 512: bf16 reads them as sub-pages)
PAGED_ROW_CASES = [(8, 4, 16, 40, (56, 8, 128)), (8, 4, 16, 40, (96, 8, 192)),
                   (6, 6, 16, 20, (96, 8, 192)), (2, 70, 16, 12, (8, 8, 128)),
                   (3, 4, 8, 24, (84, 7, 32)), (4, 4, 4, 30, (28, 4, 96)),
                   (4, 1, 1, 200, (16, 8, 128)), (4, 1, 2, 120, (16, 8, 128)),
                   (4, 1, 4, 80, (16, 8, 128)), (4, 1, 8, 40, (16, 8, 128)),
                   (4, 1, 32, 12, (16, 8, 128)), (4, 4, 1, 150, (32, 4, 64)),
                   (3, 1, 300, 3, (16, 8, 128)), (2, 4, 512, 2, (32, 4, 64)),
                   (6, 4, 32, 16, (16, 8, 128))]


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
    rows on scrambled disjoint pages, S candidate query rows each at
    positions pos[b] .. pos[b] + S - 1 through table row b (q
    (slots,S,Hq,dh), pos (slots,S)), the slots' positions at the edges of
    the planned splits and stages; pages outside the live prefixes
    poisoned.  Returns the inputs and the clean pools."""
    import torch
    Hq, Hk, dh = heads
    plan = PA.plan(slots, S, Hq, Hk, dh, n_max, P, dtype)
    w, st, last = plan.span * P, max(1, plan.pages) * P, n_max * P - S
    base = [0, w - 3, w - 1, w, w + 1, last, st - 2, last // 2][:slots]
    args, pools = paged_case(slots, slots * n_max + 1, P, n_max, Hq, Hk, dh,
                             dtype, seed, pos=torch.tensor(
                                 [p + S - 1 for p in base], dtype=torch.int32))
    q, kp, vp, bt, _ = args
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    qv = torch.randn(slots, S, Hq, dh, generator=g, device="cuda").to(dtype)
    pos = (torch.tensor(base, dtype=torch.int32, device="cuda")[:, None]
           + torch.arange(S, dtype=torch.int32, device="cuda"))
    return (qv, kp, vp, bt, pos), pools


def rows_paged_case(PA, B, S, P, n_max, heads, dtype, seed):
    """S query rows a table row (q (B,S,Hq,dh), pos (B,S)) at the edges
    of the planned splits and stages, one row's first candidates below 0,
    a row wholly below 0 where B > 4; pages outside the live prefixes
    poisoned.  Returns the inputs and the clean pools."""
    import torch
    Hq, Hk, dh = heads
    # (the fp32 plan's splits where bf16 reads sub-pages)
    plan = PA.plan(B, S, Hq, Hk, dh, n_max, P,
                   dtype if P <= PA.MAX_SLOT else torch.float32)
    w, st, last = plan.span * P, max(1, plan.pages) * P, n_max * P - 1
    edges = [last, w - 1, w, st - 1, st, w + st, S - 3, 2 * w + 1]
    top = [min(last, edges[b % len(edges)]) for b in range(B)]
    if B > 4:
        top[4] = -1
    args, pools = paged_case(B, B * n_max + 4, P, n_max, Hq, Hk, dh, dtype,
                             seed, pos=torch.tensor(top, dtype=torch.int32))
    q, kp, vp, bt, _ = args
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    qv = torch.randn(B, S, Hq, dh, generator=g, device="cuda").to(dtype)
    pos = (torch.tensor(top, dtype=torch.int32, device="cuda")[:, None]
           - torch.arange(S - 1, -1, -1, dtype=torch.int32, device="cuda"))
    return (qv, kp, vp, bt, pos.contiguous()), pools


def split_positions(PA, B, Hq, Hk, dh, n_max, P, dtype):
    """Positions at the edges of the planned splits: 0, span-1, span,
    span+1 (in positions), the last position, -1 (no key), and two more."""
    span = PA.plan(B, 1, Hq, Hk, dh, n_max, P, dtype).span
    w, last = span * P, n_max * P - 1
    edges = [0, w - 1, w, w + 1, last, -1, last // 3, 2 * w + 1]
    if B == 1:
        return [last]
    return [min(last, edges[b % len(edges)]) for b in range(B)]


def plan_text(PA, q, pool, bt):
    """The plan of a paged call as the wrapper makes it (the card's
    blocks an SM), for a check's or a timing's line."""
    import torch
    S = q.shape[1] if q.dim() == 4 else 1
    bf16 = q.dtype == torch.bfloat16
    if bf16 and pool.shape[1] > PA.MAX_SLOT:       # read as sub-pages
        pool, _, bt = PA.box_pages(pool, pool, bt)
    p = PA.plan(q.shape[0], S, q.shape[-2], pool.shape[2], q.shape[-1],
                bt.shape[1], pool.shape[1], q.dtype,
                PA.blocks_per_sm(q.shape[-1]) if bf16 else None)
    if not bf16:
        return f"splits={p.splits} span={p.span}"
    return (f"rows={p.rows}{f' x {p.chunks} chunks' if p.chunks > 1 else ''}"
            f" tiles={p.tiles} pages={p.pages} stages={p.stages} "
            f"splits={p.splits} span={p.span} blocks={p.blocks}")


def check_paged(torch, PA, name, args, clean_pools, tol):
    """Poisoned stale pages invisible bit for bit, a second call
    bit-identical, rows at pos -1 zero, the rest within tol of plain; for
    S query rows a table row also within tol of the same rows one a table
    row (the table repeated)."""
    out = PA.paged_attention(*args)
    again = PA.paged_attention(*args)
    clean = PA.paged_attention(args[0], *clean_pools, *args[3:])
    flat = None
    if args[0].dim() == 4:
        q, kp, vp, bt, pos = args
        B, S = pos.shape
        flat = PA.paged_attention(q.reshape(B * S, *q.shape[2:]), kp, vp,
                                  bt.repeat_interleave(S, dim=0),
                                  pos.reshape(-1)).reshape(q.shape)
    torch.cuda.synchronize()
    if not torch.equal(out, clean):
        fail(f"{name}: poisoned stale pages changed the output")
    if not torch.equal(out, again):
        fail(f"{name}: two identical calls differ")
    dead = args[4] < 0
    if not bool((out[dead] == 0).all()):
        fail(f"{name}: a row with no key did not emit 0")
    ref = PA.reference(*args)
    err = check_close(name, out[~dead], ref[~dead], tol)
    if flat is not None:
        check_close(f"{name} (against the repeated table)", out, flat, tol)
    return err


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
            plan = FA.plan(B, S, T, Hq, Hk, dh, causal, window)
            name = (f"flash {dtype} {(B, S, T, Hq, Hk, dh)} causal={causal} "
                    f"window={window}" + (
                        f" rows={plan.rows} pack={plan.pack} "
                        f"splits={plan.splits}" if dtype == "bfloat16"
                        else ""))
            if not torch.equal(out, again):
                fail(f"{name}: two identical calls differ")
            # causal with S > T: the first S - T rows see no key and emit
            # 0, where the plain version averages them uniformly
            dead = max(0, S - T) if causal else 0
            if not bool((out[:, :dead] == 0).all()):
                fail(f"{name}: a row with no key did not emit 0")
            ref = FA.reference(q, k, v, causal=causal, window=window)
            e = check_close(name, out[:, dead:], ref[:, dead:], TOL[dtype])
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
                          torch.tensor(split_positions(PA, B, Hq, Hk, dh,
                                                       n_max, P, dt),
                                       dtype=torch.int32)))
        for i, (shp, pos) in enumerate(cases):
            args, pools = paged_case(*shp, dt, seed=10 + i, pos=pos)
            plan = plan_text(PA, args[0], args[1], args[3])
            e = check_paged(torch, PA, f"paged {dtype} {shp} {plan} "
                            f"pos={args[4].tolist()}", args, pools,
                            TOL[dtype])
            rows.append(["paged_attention", dtype, shp, plan, e])
            if dtype == "bfloat16" and i < 2:
                key = ("paged_attention" if i == 0
                       else f"paged_attention@{HYBRID}")
                errs[key] = max(errs[key], e)
        # phase 4c's and 4d's decode shapes, at random positions
        for arch, shp in (*FAMILY_PAGED.items(), *LAST_PAGED.items()):
            args, pools = paged_case(*shp, dt, seed=10)
            plan = plan_text(PA, args[0], args[1], args[3])
            e = check_paged(torch, PA, f"paged {dtype} {shp} ({arch}) "
                            f"{plan} pos={args[4].tolist()}",
                            args, pools, TOL[dtype])
            rows.append(["paged_attention", dtype, shp, f"{arch}, {plan}",
                         e])
            if dtype == "bfloat16":
                errs[f"paged_attention@{arch}"] = e
        # the verify shape: 8 slots x S 4 candidate rows (qwen3-1.7b)
        args, pools = verify_paged_case(PA, dt, seed=30)
        plan = plan_text(PA, args[0], args[1], args[3])
        e = check_paged(torch, PA, f"paged verify {dtype} {plan} "
                        f"pos={args[4].tolist()}", args, pools, TOL[dtype])
        rows.append(["paged_attention", dtype, tuple(args[0].shape),
                     f"verify, {SLOTS} slots x S {SPEC_K + 1}, {plan}", e])
        if dtype == "bfloat16":
            errs["paged_attention@verify"] = e
        # S query rows a table row at the plan's edges: G 7 and 12 with
        # S 4 (28 and 48 rows a block), and page sizes 1-32 (page slots
        # padded to 8 rows, 1-8 pages a stage)
        for j, (B, S, P, n_max, heads) in enumerate(PAGED_ROW_CASES):
            args, pools = rows_paged_case(PA, B, S, P, n_max, heads, dt,
                                          seed=40 + j)
            plan = plan_text(PA, args[0], args[1], args[3])
            e = check_paged(torch, PA, f"paged rows {dtype} "
                            f"{(B, S, P, n_max, *heads)} {plan} "
                            f"pos={args[4].tolist()}", args, pools,
                            TOL[dtype])
            rows.append(["paged_attention", dtype, (B, S, P, n_max, *heads),
                         f"S {S} rows a table row, {plan}", e])
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
    shape; and every call made twice, the two bit-identical.  Also many
    chunks: S 2048 in 16 of 128 and in 8 of 256 (P = N = 128, where fp32
    tiles by 32), S 4096 in 16 of 256, S 544 in 17 of 32 over 3 heads."""
    shapes = [(1, 512, 64, 64, 64, 128),            # zamba2-1.2b prefill
              (2, 256, 4, 64, 64, 128), (1, 128, 2, 32, 16, 64),
              (2, 512, 3, 64, 64, 128), (1, 256, 1, 128, 32, 256),
              (1, 384, 2, 64, 64, 128), (2, 40, 4, 16, 128, 128),
              (1, 96, 4, 64, 64, 32),
              (1, 500, 64, 64, 64, 128),            # ragged last chunks
              (2, 130, 4, 64, 64, 128), (1, 17, 2, 16, 16, 32),
              (1, 300, 2, 128, 128, 256),   # fp32: the kernel tiles by 32
              (1, 2048, 64, 64, 64, 128), (1, 4096, 8, 64, 64, 256),
              (1, 2048, 2, 128, 128, 256), (1, 544, 3, 32, 64, 32)]

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
          split_ticks=False, recorder=None):
    """One warm run of the requests through a fresh paged engine
    (`num_pages` pages, default every slot at full length; or the one
    `engine()` builds), the launch counters zeroed just before and read
    just after.  A model draft's prefill adds `draft_layers` flash
    launches to every admit.  Returns the requests, the finished ones, the
    launches, the engine's stats (with the run's peak device memory, and
    with `split_ticks` the seconds of its admits and decode chunks, a
    synchronize after each), the wall time and the prefill lengths of
    every admit by request id.  With `recorder` (a `repro_torch.obs`
    Recorder) the timed run is recorded, the warm-up not."""
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
    from repro_torch import obs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    prev = obs.install(recorder)
    try:
        t0 = time.perf_counter()
        fins = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        obs.install(prev)
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


def percentiles(xs):
    import numpy as np
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def recorded_serve(torch, card, cfg, params, ops, ServeEngine, Request,
                   fins_ref, tps_ref, trace_dir):
    """Phase 4's stream once more under a `repro_torch.obs` Recorder:
    the greedy streams equal the unrecorded run's, one
    `serve.first_token` and one `request` span a request, one
    `serve.admit` an admit (re-admits included), the port's trace file
    parses back with the same event count.  Returns the run's latency
    figures: admit -> first token (the first token is harvested with the
    next decode chunk, so this is when the host could stream it), and ms
    an output token, (request span - admit -> first token) / (tokens - 1);
    neither sees the queueing before an admit.  Both assume no request
    was preempted (a re-admit restarts the request's clock and emits
    another first token), so a run that preempts fails."""
    from repro_torch import obs
    from repro_torch.obs.trace import write_trace
    rec = obs.Recorder()
    reqs, fins, launches, st, wall, admits = serve(
        torch, cfg, params, ops, ServeEngine, Request, recorder=rec)
    if [f.tokens for f in fins] != [f.tokens for f in fins_ref]:
        fail(f"{cfg.name} recorded serve: streams differ from the "
             f"unrecorded run's")
    if st["preemptions"]:
        fail(f"{cfg.name} recorded serve: {st['preemptions']} preemptions;"
             f" the latency figures assume none")
    evs = rec.events
    rids = sorted(r.rid for r in reqs)
    for name, ph in (("serve.first_token", "i"), ("request", "X")):
        got = sorted(e.args["rid"] for e in evs
                     if e.name == name and e.ph == ph)
        if got != rids:
            fail(f"{cfg.name} recorded serve: {name} for rids {got}, want "
                 f"one for each of {rids}")
    n_admit = sum(e.name == "serve.admit" for e in evs)
    if n_admit != len(admits) or n_admit != st["prefill_ticks"]:
        fail(f"{cfg.name} recorded serve: {n_admit} serve.admit events, "
             f"{len(admits)} admits ({st['prefill_ticks']} prefill ticks)")
    path = write_trace(os.path.join(trace_dir, "serve_trace.json"), evs)
    with open(path) as fh:
        back = [e for e in json.load(fh)["traceEvents"] if e["ph"] != "M"]
    if len(back) != len(evs):
        fail(f"trace {path}: {len(back)} events, recorded {len(evs)}")
    first_admit, first_tok = {}, {}
    for e in evs:
        if e.name == "serve.admit":
            first_admit.setdefault(e.args["rid"], e.ts)
        elif e.name == "serve.first_token":
            first_tok.setdefault(e.args["rid"], e.ts)
    ttft = {r: 1e3 * (first_tok[r] - first_admit[r]) for r in rids}
    tpot = [(1e3 * e.dur - ttft[e.args["rid"]]) / (e.args["tokens"] - 1)
            for e in evs if e.name == "request" and e.args["tokens"] > 1]
    tps = st["generated_tokens"] / wall
    out = {"launches": launches, "events": len(evs), "wall_s": wall,
           "tok_s": tps, "tok_s_unrecorded": tps_ref,
           "admit_to_first_token_ms": percentiles(list(ttft.values())),
           "ms_per_output_token": percentiles(tpot), "trace": path,
           "counts": {n: sum(e.name == n for e in evs) for n in
                      sorted({e.name for e in evs})}}
    print(f"serve recorded [{card}]: {cfg.name} streams equal to the "
          f"unrecorded run's, {len(evs)} events {json.dumps(out['counts'])}"
          f", trace {path} parsed back with {len(back)} events; "
          f"launches={launches}")
    t, p = out["admit_to_first_token_ms"], out["ms_per_output_token"]
    print(f"serve latency [{card}]: {cfg.name} admit -> first token "
          f"p50 {t['p50']:.2f} ms p99 {t['p99']:.2f} ms; ms an output "
          f"token p50 {p['p50']:.3f} p99 {p['p99']:.3f} (no queueing "
          f"before admit)")
    print(f"serve tokens/s [{card}]: {cfg.name} recorded {tps:.1f}, "
          f"unrecorded {tps_ref:.1f}")
    return out


# the port's own kernels, by the names of their CUDA functions
PORT_KERNELS = ("flash_fwd", "flash_combine", "paged_tc", "paged_decode",
                "paged_merge", "ssd_state",
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
    return {"shape": [B, Hq, Hk, dh, P, n_max], "pos": pos_list, "ms": ms,
            "call_ms": call_ms, "plan": plan_text(PA, q, kp, bt),
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "gather + scaled_dot_product_attention",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def time_paged_verify(torch, PA, heads, pos_list, S=SPEC_K + 1):
    """The paged kernel at the verify shape, as attention_verify launches
    it: every slot's S candidate rows through its table row (q
    (B,S,Hq,dh), pos (B,S)), row (b, i) at position pos[b] + i.  Library:
    the slots' K/V gathered once, then one scaled_dot_product_attention
    of S queries a slot under the candidates' causal mask.  The bound
    counts each slot's pages once, up to its last candidate."""
    (Hq, Hk, dh), B, P = heads, len(pos_list), PAGE
    n_max = -(-(PLEN[1] + GEN[1]) // P)
    Np = B * n_max
    g = torch.Generator(device="cuda").manual_seed(46)
    q = torch.randn(B, S, Hq, dh, generator=g, device="cuda").bfloat16()
    kp = torch.randn(Np + 1, P, Hk, dh, generator=g, device="cuda").bfloat16()
    vp = torch.randn(Np + 1, P, Hk, dh, generator=g, device="cuda").bfloat16()
    bt = torch.randperm(Np, generator=torch.Generator().manual_seed(5)
                        ).reshape(B, n_max).int().cuda()
    base = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    pos = (base[:, None] + torch.arange(S, device="cuda")).int()
    ms = device_ms(lambda: PA.paged_attention(q, kp, vp, bt, pos), n=50)
    call_ms = cuda_ms(lambda: PA.paged_attention(q, kp, vp, bt, pos), n=50)
    plain_ms = device_ms(lambda: PA.reference(q, kp, vp, bt, pos), n=10)
    C = n_max * P
    mask = (torch.arange(C, device="cuda")[None, None] <= pos[:, :, None]
            )[:, None]                                   # (B,1,S,C)
    qs = q.transpose(1, 2)                               # (B,Hq,S,dh)

    def library():
        kg = kp[bt.long()].reshape(B, C, Hk, dh).transpose(1, 2)
        vg = vp[bt.long()].reshape(B, C, Hk, dh).transpose(1, 2)
        return sdpa(qs, kg, vg, attn_mask=mask)
    lib_ms = device_ms(library, n=50)
    resident = sum(p + S for p in pos_list)        # positions a slot holds
    attended = int((pos.long() + 1).sum())         # (query, key) pairs
    nbytes = (2 * resident * Hk * dh * 2           # K and V, bf16
              + 2 * 2 * q.numel()                  # q and out
              + 4 * (bt.numel() + B * S))          # block tables and pos
    flops = 4 * Hq * dh * attended
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"shape": [B, S, Hq, Hk, dh, P, n_max], "pos": pos_list,
            "rows": f"{B} slots x S {S}", "ms": ms, "call_ms": call_ms,
            "plan": plan_text(PA, q, kp, bt),
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
    # the step's in-place update, on copies of the params and moments
    pk, sk = tree_map(torch.clone, params), tree_map(torch.clone, state)
    torch.cuda.synchronize()
    t = time.perf_counter()
    apply_grads(opt, pk, sk, ck)
    torch.cuda.synchronize()
    split["optimizer_ms"] = 1e3 * (time.perf_counter() - t)

    # the same gradients and uniforms through the plain round trip
    cp = tree_map(lambda g, v: NC.unpack_reference(NC.pack_reference(g, v),
                                                   g.dtype), grads, u)
    if not same_bits(ck, cp):
        fail("compressed gradients: kernels and plain versions differ")
    pp, sp = tree_map(torch.clone, params), tree_map(torch.clone, state)
    apply_grads(opt, pp, sp, cp)
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


def async_ckpt_phase(torch, card, cfg, ckpt_dir):
    """Phase 6's asynchronous checkpoint: the qwen3 train loop (the
    launcher's step: params and moments updated in place) takes a step without a save, saves through AsyncCheckpointer
    and takes the next step while the writer works.  After `wait()` a
    restore equals the saved step's params and moments bit for bit,
    though the step after the save overwrote them on the card."""
    import shutil
    from repro_torch import obs
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.optimizers import adamw, warmup_cosine

    B, S = TRAIN_BATCH, TRAIN_SEQ
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(warmup_cosine(3e-3, TRAIN_WARMUP, 4))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, compress_grads=True)
    batches = iter(make_pipeline(cfg.vocab_size, B, S, seed=0))

    def step(i):
        b = {k: torch.from_numpy(v).cuda() for k, v in next(batches).items()}
        t = time.perf_counter()
        _, _, m = step_fn(params, state, b,
                          torch.Generator(device="cuda").manual_seed(1 + i))
        loss = float(m["loss"])
        return 1e3 * (time.perf_counter() - t), loss

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rec = obs.Recorder()
    try:
        with obs.recording(rec):
            step(0)                                        # warm-up
            plain_ms, _ = step(1)
            tree = {"params": params, "opt": state}
            kept = tree_map(lambda t: t.clone(), tree)
            ck = AsyncCheckpointer(ckpt_dir)
            try:
                t = time.perf_counter()
                ck.save(2, tree, {"step": 2, "arch": cfg.name})
                save_ms = 1e3 * (time.perf_counter() - t)
                inflight_ms, loss = step(2)
                busy = ck.last_committed_step() is None
                ck.wait()
            finally:
                ck.close(wait=False)
        like = tree_map(torch.zeros_like, kept)
        back, meta = restore_checkpoint(ckpt_dir, like)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    got, want = tree_leaves(back), tree_leaves(kept)
    if meta != {"step": 2, "arch": cfg.name} or not all(
            a.dtype == b.dtype and torch.equal(bits(torch, a), bits(torch, b))
            for a, b in zip(got, want)):
        fail("asynchronous checkpoint: the restore differs from the saved "
             "step's params and moments")
    if all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                             tree_leaves(kept["params"]))):
        fail("asynchronous checkpoint: the step after the save left the "
             "params as they were")
    spans = {}
    for e in rec.events:
        if e.name.startswith("ckpt."):
            spans[e.name] = spans.get(e.name, 0.0) + 1e3 * e.dur
    writer = sum(v for k, v in spans.items() if k != "ckpt.snapshot")
    nbytes = sum(a.numel() * (4 if a.dtype == torch.bfloat16
                              else a.element_size()) for a in want)
    out = {"bytes": nbytes, "leaves": len(want), "save_call_ms": save_ms,
           "snapshot_ms": spans["ckpt.snapshot"], "writer_ms": writer,
           "spans_ms": spans, "step_ms": plain_ms,
           "step_with_save_in_flight_ms": inflight_ms,
           "writer_busy_after_step": busy, "loss": loss,
           "registry": rec.metrics()}
    print(f"async checkpoint [{card}]: {cfg.name} step 2, {len(want)} "
          f"leaves, {nbytes / 1e9:.2f} GB as stored: ckpt.snapshot "
          f"{spans['ckpt.snapshot']:.1f} ms (save returned in "
          f"{save_ms:.1f} ms), writer {writer:.1f} ms "
          f"({json.dumps({k: round(v, 1) for k, v in spans.items()})}); "
          f"a step {plain_ms:.1f} ms without a save, {inflight_ms:.1f} ms "
          f"with the save in flight (writer still busy after it: {busy}); "
          f"restore bit-equal to the saved params and moments")
    return out


def leafwise_roundtrip_check(torch, ops, NC, grads, seed):
    """The nc kernels against their plain versions on one step's gradients
    and the same uniforms, a leaf at a time (a model of billions of
    params cannot hold two compressed gradient trees at once): every
    compressed gradient leaf bit-identical, and the two paths' global
    norms, the clip's one input beyond the leaf, equal.  Returns the
    number of gradient elements and of those not finite (phi-3's, from
    the stub frontend's zero patches: ROADMAP queue 3)."""
    from repro_torch.models.common import tree_leaves
    gen = torch.Generator(device="cuda").manual_seed(seed)
    norms, n, nonfinite = [0, 0], 0, 0
    for g in tree_leaves(grads):
        u = torch.rand(g.shape, generator=gen, dtype=torch.float32,
                       device="cuda")
        ck = ops.nc_roundtrip(g, u)
        cp = NC.unpack_reference(NC.pack_reference(g, u), g.dtype)
        if not torch.equal(bits(torch, ck), bits(torch, cp)):
            fail("compressed gradients: kernels and plain versions differ")
        norms = [m + c.float().square().sum() for m, c in zip(norms,
                                                              (ck, cp))]
        n += g.numel()
        nonfinite += int((~torch.isfinite(g)).sum())
    if not torch.equal(norms[0], norms[1]):
        fail(f"compressed gradients: global norms differ, "
             f"{float(norms[0].sqrt())} vs {float(norms[1].sqrt())}")
    return n, nonfinite


def family_train_phase(torch, card, ops, NC):
    """Phase 6 for the other families: each trains at full width (rwkv6
    with its depth cut, `--layers`) through the launcher
    (`repro_torch.launch.train`, bf16, block remat, AdamW, compressed
    gradients through nc_pack / nc_unpack, in-place steps) under a Recorder,
    one model after another, each freed before the next: one warm-up step
    and TRAIN_TIMED timed ones, the step times read
    from the `train.step` spans; losses finite, nc launches exactly
    leaves x steps, no attention or scan kernel; then one more step's
    gradients through the kernels and the plain versions, leaf by leaf."""
    import gc
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import loss_and_grads, make_extra
    from repro_torch.launch.train import train
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.config import param_count
    out = []
    steps = 1 + TRAIN_TIMED
    for arch, B, S, layers, cut in TRAIN_FAMILIES:
        t_model = time.perf_counter()
        cfg = get_config(arch)
        depth = []
        if layers:
            cfg = cfg.with_(num_layers=layers)
            depth = ["--layers", str(layers)]
        total, _ = param_count(cfg)
        n_leaves = len(tree_leaves(MD.model_descs(cfg)))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        rec = obs.Recorder()
        with obs.recording(rec):
            res = train(["--arch", arch, "--steps", str(steps),
                         "--batch", str(B), "--seq", str(S),
                         "--compress-grads", "--log-every", "1000"] + depth)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {n: getattr(ops, n).launches for n in
                    ("nc_pack", "nc_unpack", "flash_attention",
                     "paged_attention", "ssd_scan")}
        losses = res["losses"]
        want = n_leaves * steps
        if launches["nc_pack"] != want or launches["nc_unpack"] != want:
            fail(f"{arch} train: nc launches {launches}, want {want} each "
                 f"({n_leaves} gradient leaves x {steps} steps)")
        if any(launches[k] for k in ("flash_attention", "paged_attention",
                                     "ssd_scan")):
            fail(f"{arch} train launched an attention or scan kernel: "
                 f"{launches}")
        if len(losses) != steps or not all(
                v == v and abs(v) != float("inf") for v in losses):
            fail(f"{arch} train: losses {losses}")
        spans = [1e3 * e.dur for e in rec.events if e.name == "train.step"]
        if len(spans) != steps:
            fail(f"{arch} train: {len(spans)} train.step spans, want {steps}")
        ms = sum(spans[1:]) / TRAIN_TIMED
        params = res["params"]
        del res
        b = {k: torch.from_numpy(v).cuda() for k, v in
             next(iter(make_pipeline(cfg.vocab_size, B, S, seed=1))).items()}
        extra = make_extra(cfg, B, torch.device("cuda"))
        if extra is not None:
            b["extra_embeds"] = extra
        _, grads = loss_and_grads(params, cfg, b)
        del b, extra
        n, nonfinite = leafwise_roundtrip_check(torch, ops, NC, grads,
                                                seed=steps + 1)
        del params, grads
        gc.collect()
        torch.cuda.empty_cache()
        patches = (seeded_patch_train(torch, card, cfg, B, S)
                   if cfg.arch_type == "vlm" else None)
        prefix = f" plus {cfg.num_patches} patches" if cfg.arch_type == \
            "vlm" else ""
        r = {"arch": arch, "params": total, "batch": B, "seq": S,
             "cut": cut, "steps": steps, "losses": losses,
             "step_ms": spans, "ms_per_step": ms,
             "tok_s": B * S / (ms / 1e3), "peak_mem_gb": peak / 1e9,
             "launches": launches, "n_leaves": n_leaves,
             "grad_elements": n, "grad_nonfinite": nonfinite,
             "seeded_patches": patches,
             "seconds": time.perf_counter() - t_model}
        out.append(r)
        print(f"train [{card}]: {arch} {total / 1e9:.2f}B params bf16, "
              f"remat={cfg.remat}, batch {B} x seq {S}{prefix}"
              f"{' (' + cut + ')' if cut else ''}, {TRAIN_TIMED} timed "
              f"steps (train.step spans): {ms:.1f} ms/step, "
              f"{r['tok_s']:.0f} tokens/s, peak memory "
              f"{r['peak_mem_gb']:.2f} GB, launches {launches}, losses "
              f"{[round(x, 4) for x in losses]}; kernel vs plain "
              f"compression on {n_leaves} leaves ({n} elements, {nonfinite} "
              f"not finite before it): gradients bit-identical, global "
              f"norms equal; {r['seconds']:.1f} s")
    return out


def seeded_patch_train(torch, card, cfg, B, S):
    """ROADMAP queue 3's decision on the vlm stub's zero patches: the
    launchers keep them (the JAX launcher's), and this run feeds
    phi-3-vision-4.2b patches drawn from seed PATCH_SEED on the card
    through the batch's `extra_embeds`, as a caller of the train step
    may.  Fresh weights (seed 0), PATCH_STEPS steps of the launcher's
    step (AdamW, warmup 1 to PATCH_LR, compressed gradients, in place) on
    one batch of B x S tokens: every gradient norm finite, the loss
    falls."""
    import gc
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as MD
    from repro_torch.models.common import torch_dtype
    from repro_torch.optim.optimizers import adamw, warmup_cosine
    t = time.perf_counter()
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(warmup_cosine(PATCH_LR, 1, PATCH_STEPS))
    state = opt.init(params)
    step = make_train_step(cfg, opt, compress_grads=True)
    b = {k: torch.from_numpy(v).cuda() for k, v in
         next(iter(make_pipeline(cfg.vocab_size, B, S, seed=0))).items()}
    g = torch.Generator(device="cuda").manual_seed(PATCH_SEED)
    b["extra_embeds"] = torch.randn(
        (B, cfg.num_patches, MD.VISION_EMBED_DIM), generator=g,
        device="cuda").to(torch_dtype(cfg.compute_dtype))
    losses, gnorms = [], []
    for i in range(PATCH_STEPS):
        params, state, m = step(params, state, b, torch.Generator(
            device="cuda").manual_seed(PATCH_SEED + 1 + i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    del params, state, b
    gc.collect()
    torch.cuda.empty_cache()
    if not (finite(gnorms) and finite(losses)
            and losses[-1] < losses[0]):
        fail(f"{cfg.name} on seeded patches: losses {losses}, gradient "
             f"norms {gnorms}")
    out = {"steps": PATCH_STEPS, "lr": PATCH_LR, "losses": losses,
           "gnorms": gnorms, "seconds": time.perf_counter() - t}
    print(f"train [{card}]: {cfg.name} on patches drawn from seed "
          f"{PATCH_SEED} (ROADMAP queue 3), {PATCH_STEPS} steps on one "
          f"batch of {B} x {S}: gradient norms "
          f"{[round(x, 4) for x in gnorms]} (finite), losses "
          f"{[round(x, 4) for x in losses]} (falling); "
          f"{out['seconds']:.1f} s")
    return out


def serve_path(torch, card, arch, ops, MD, SS, ServeEngine, Request,
               profile=False, trace_dir=None):
    """Phase 4 for one model: the warm serve run with its launch counts,
    with `trace_dir` the same run recorded (its trace written there), the
    --profile split and trace, kernel path vs plain path, and for the
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
    recorded = None
    if trace_dir:
        recorded = recorded_serve(torch, card, cfg, params, ops, ServeEngine,
                                  Request, fins, tps, trace_dir)
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
            "plain_paths": plain, "tight_pool": tight,
            "recorded": recorded}, fins


# ---------------------------------------------------------------------------
# phase 7: data parallelism, resharding and the coordinator
# ---------------------------------------------------------------------------
def finite(xs):
    return all(v == v and abs(v) != float("inf") for v in xs)


def dir_bytes_equal(a, b, chunk=1 << 26):
    """Two directory trees hold the same files with the same bytes (read
    in chunks of 64 MiB)."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    def same(x, y):
        if os.path.getsize(x) != os.path.getsize(y):
            return False
        with open(x, "rb") as fx, open(y, "rb") as fy:
            while True:
                bx, by = fx.read(chunk), fy.read(chunk)
                if bx != by:
                    return False
                if not bx:
                    return True

    names = files(a)
    return names == files(b) and all(
        same(os.path.join(a, f), os.path.join(b, f)) for f in names)


def dp_phase(torch, card, ops, train_ms):
    """Phase 7: qwen3-0.6b at full width through `core/data_parallel`,
    `elastic/reshard` and `cluster/` on the card.  (a) timed S-SGD
    steps, W workers of 1 x DP_SEQ (phase 6's 2 x 4096 split), bf16,
    block remat, all-reduce with natural-compressed gradients from CUDA
    uniforms, AdamW through opt.update; (b) fp32 S-SGD equal to one step
    on the joined batch, and ps equal to all-reduce; (c) a round of local
    SGD and of EASGD; (d) reshard, save and restore of the stacked
    params on the card; (e) the Coordinator over two real worker
    processes.  Every step is held to its gate."""
    import gc
    import shutil
    from repro_torch.cluster import Coordinator, ProcTransport, SimTransport
    from repro_torch.configs import get_config
    from repro_torch.core import data_parallel as DP
    from repro_torch.data import make_pipeline
    from repro_torch.elastic import (FailureTrace, TraceEvent,
                                     reshard_stacked, restore_stacked,
                                     save_stacked)
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.optimizers import (adamw, sgd_momentum,
                                              warmup_cosine)
    t_phase = time.perf_counter()
    out = {}
    W = DP_W
    gc.collect()
    torch.cuda.empty_cache()

    def batches_w(seq, n, seed, K=None):
        """n (W[, K]) x 1 x seq batches on the card from the pipeline's
        (W [x K]) x seq ones."""
        rows = W * (K or 1)
        pipe = iter(make_pipeline(cfg.vocab_size, rows, seq, seed=seed))
        lead = (W, K) if K else (W,)
        return [{k: torch.from_numpy(v).cuda().reshape(lead + (1, seq))
                 for k, v in next(pipe).items()} for _ in range(n)]

    # (a) timed sync_step, bf16 ------------------------------------------
    cfg = get_config(ARCH)
    loss_fn = lambda p, b: MD.lm_loss(p, cfg, b)
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n = sum(t.numel() for t in tree_leaves(params))
    opt = adamw(warmup_cosine(3e-3, TRAIN_WARMUP, 1 + DP_TIMED))
    state = opt.init(params)
    data = batches_w(DP_SEQ, 2 + DP_TIMED, seed=0)

    def noise(i):
        return torch.Generator(device="cuda").manual_seed(1 + i)

    params, state, m = DP.sync_step(loss_fn, params, opt, state, data[0],
                                    noise=noise(0))                # warm-up
    losses = [float(m["loss"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    for i, b in enumerate(data[1:-1]):
        params, state, m = DP.sync_step(loss_fn, params, opt, state, b,
                                        noise=noise(1 + i))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / DP_TIMED
    peak = torch.cuda.max_memory_allocated()
    launches = {k: getattr(ops, k).launches for k in
                ("nc_pack", "nc_unpack", "flash_attention", "paged_attention")}
    # one more step, split into its parts with a synchronize between them
    dp_split = {}
    t1 = time.perf_counter()
    _, grads_w = DP.per_worker_grads(loss_fn, params, data[-1])
    torch.cuda.synchronize()
    dp_split["forward_backward_ms"] = 1e3 * (time.perf_counter() - t1)
    t1 = time.perf_counter()
    g, _ = DP.aggregate(grads_w, "allreduce", noise(1 + DP_TIMED))
    torch.cuda.synchronize()
    dp_split["aggregate_ms"] = 1e3 * (time.perf_counter() - t1)
    del grads_w
    t1 = time.perf_counter()
    opt.update(g, state, params)
    torch.cuda.synchronize()
    dp_split["update_ms"] = 1e3 * (time.perf_counter() - t1)
    del g
    per_worker = 2 * n * (W - 1) // W
    want = {"comm_bytes": per_worker * W, "bottleneck_link_bytes": per_worker,
            "comm_events": W}
    got = {k: m[k] for k in want}
    if not finite(losses):
        fail(f"dp sync_step: losses {losses}")
    if got != want:
        fail(f"dp sync_step: comm {got}, closed forms {want} ({n} params)")
    if any(launches.values()):
        fail(f"dp sync_step: the aggregate compresses with the plain "
             f"natural_compress, yet kernels launched: {launches}")
    out["sync_step"] = {"W": W, "seq": DP_SEQ, "params": n,
                        "losses": losses, "ms_per_step": ms,
                        "phase6_ms_per_step": train_ms,
                        "peak_mem_gb": peak / 1e9, "comm": got,
                        "launches": launches, "split_ms": dp_split}
    print(f"dp sync_step [{card}]: {ARCH} {n} params {cfg.param_dtype}, "
          f"W {W} x 1 x "
          f"{DP_SEQ}, allreduce, natural-compressed (CUDA uniforms), AdamW: "
          f"{ms:.1f} ms/step over {DP_TIMED} steps (phase 6: {train_ms:.1f} "
          f"ms/step at {TRAIN_BATCH} x {TRAIN_SEQ}), peak memory "
          f"{peak / 1e9:.2f} GB, comm_bytes {got['comm_bytes']}, "
          f"bottleneck_link_bytes {got['bottleneck_link_bytes']}, "
          f"comm_events {got['comm_events']} (the closed forms), losses "
          f"{[round(x, 4) for x in losses]}; one more step split "
          f"{json.dumps({k: round(v, 1) for k, v in dp_split.items()})}")
    del params, state, data
    gc.collect()
    torch.cuda.empty_cache()

    # (b) equivalence in fp32 ---------------------------------------------
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    loss32 = lambda p, b: MD.lm_loss(p, cfg32, b)
    p0 = MD.init_model(cfg32, torch.Generator(device="cuda").manual_seed(1))
    sgd = sgd_momentum(lambda s: EQ_LR, momentum=0.0)
    b = batches_w(EQ_SEQ, 1, seed=2)[0]
    p_ar, _, m_ar = DP.sync_step(loss32, p0, sgd, sgd.init(p0), b)
    p_ps, _, m_ps = DP.sync_step(loss32, p0, sgd, sgd.init(p0), b, mode="ps")
    joined = {k: v.reshape(W, EQ_SEQ) for k, v in b.items()}
    _, g = DP.value_and_grad(loss32, p0, joined)
    p_one = tree_map(lambda p, gg: p - EQ_LR * gg, p0, g)
    del g
    err = max(float((a - c).abs().max()) for a, c in
              zip(tree_leaves(p_ar), tree_leaves(p_one)))
    upd = max(float((c - a).abs().max()) for a, c in
              zip(tree_leaves(p0), tree_leaves(p_one)))
    if not err <= EQ_TOL * upd:
        fail(f"dp equivalence: max|sync - single| {err:.3g} > {EQ_TOL} x "
             f"the largest update element {upd:.3g}")
    if not same_tree_bits(torch, p_ps, p_ar):
        fail("dp equivalence: ps params differ from allreduce's")
    if not m_ps["bottleneck_link_bytes"] > m_ar["bottleneck_link_bytes"]:
        fail(f"dp equivalence: ps bottleneck {m_ps} not above allreduce's "
             f"{m_ar}")
    out["equivalence"] = {"seq": EQ_SEQ, "lr": EQ_LR, "max_err": err,
                          "max_update": upd, "gate": EQ_TOL * upd,
                          "ps_bottleneck": m_ps["bottleneck_link_bytes"],
                          "allreduce_bottleneck":
                              m_ar["bottleneck_link_bytes"]}
    print(f"dp equivalence [{card}]: fp32, W {W} x 1 x {EQ_SEQ}, SGD "
          f"(momentum 0, lr {EQ_LR}): max|sync_step - one step on the "
          f"joined batch| {err:.3g} <= {EQ_TOL} x the largest update "
          f"element {upd:.3g}; ps params bit-equal to allreduce, "
          f"bottleneck link {m_ps['bottleneck_link_bytes']} > "
          f"{m_ar['bottleneck_link_bytes']}")
    del p0, p_ar, p_ps, p_one
    gc.collect()
    torch.cuda.empty_cache()

    # (c) local SGD and EASGD, bf16 -----------------------------------------
    base = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(3))
    stack = lambda t: t.unsqueeze(0).repeat((W,) + (1,) * t.dim())
    data_k = batches_w(LOCAL_SEQ, 1, seed=4, K=LOCAL_K)[0]
    sgd_m = sgd_momentum(lambda s: LOCAL_LR, momentum=0.9)
    params_w = tree_map(stack, base)
    states_w = tree_map(stack, sgd_m.init(base))
    t = time.perf_counter()
    params_w, states_w, m_l = DP.local_sgd_round(loss_fn, params_w, sgd_m,
                                                 states_w, data_k)
    loss_l = float(m_l["loss"])
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t
    rows_equal = all(torch.equal(bits(torch, x[0]), bits(torch, x[w]))
                     for x in tree_leaves(params_w) for w in range(1, W))
    want_l = 2 * n * 4 * (W - 1)
    if not (finite([loss_l]) and rows_equal and m_l["comm_bytes"] == want_l):
        fail(f"dp local SGD: loss {loss_l}, rows bit-equal {rows_equal}, "
             f"comm_bytes {m_l['comm_bytes']} (closed form {want_l})")
    del params_w, states_w
    ecfg = DP.EASGDConfig(lr=LOCAL_LR, rho=0.1)
    t = time.perf_counter()
    ez_w, center, m_e = DP.easgd_round(loss_fn, tree_map(stack, base), base,
                                       data_k, ecfg)
    loss_e = float(m_e["loss"])
    torch.cuda.synchronize()
    easgd_s = time.perf_counter() - t
    esize = {t.element_size() for t in tree_leaves(base)}
    want_e = 2 * n * esize.pop() * W if len(esize) == 1 else None
    if not (finite([loss_e]) and m_e["comm_bytes"] == want_e):
        fail(f"dp EASGD: loss {loss_e}, comm_bytes {m_e['comm_bytes']} "
             f"(closed form {want_e})")
    # the rows went apart on different batches (bf16 swallows the
    # smallest updates): reported, so (d)'s survivor checks mean something
    rows_apart = sum(int((x[0] != x[1]).sum()) for x in tree_leaves(ez_w))
    out["local_sgd"] = {"K": LOCAL_K, "seq": LOCAL_SEQ, "loss": loss_l,
                        "comm_bytes": m_l["comm_bytes"], "seconds": local_s}
    out["easgd"] = {"K": LOCAL_K, "seq": LOCAL_SEQ, "loss": loss_e,
                    "comm_bytes": m_e["comm_bytes"], "seconds": easgd_s,
                    "elements_apart": rows_apart}
    print(f"dp local SGD / EASGD [{card}]: {cfg.param_dtype}, W {W}, "
          f"K {LOCAL_K} x 1 x "
          f"{LOCAL_SEQ}: local SGD loss {loss_l:.4f}, rows bit-equal after "
          f"the average, comm_bytes {m_l['comm_bytes']} (fp32 mean), "
          f"{local_s:.2f} s; EASGD loss {loss_e:.4f}, comm_bytes "
          f"{m_e['comm_bytes']}, the rows apart in {rows_apart} of {n} "
          f"elements, {easgd_s:.2f} s")
    del base, center, data_k
    gc.collect()
    torch.cuda.empty_cache()

    # (d) reshard, save and restore on the card -----------------------------
    t = time.perf_counter()
    split = {}
    moved = reshard_stacked(ez_w, [0, 1], [1, 2])
    mean_row = tree_map(lambda x: DP.worker_mean(x[1:2]).to(x.dtype), ez_w)
    if not (same_tree_bits(torch, tree_map(lambda x: x[0], moved),
                           tree_map(lambda x: x[1], ez_w))
            and same_tree_bits(torch, tree_map(lambda x: x[1], moved),
                               mean_row)):
        fail("dp reshard [0, 1] -> [1, 2]: survivor row not bit-equal, or "
             "the joiner not the fp32 mean cast back")
    del moved, mean_row
    torch.cuda.synchronize()
    split["reshard_s"] = time.perf_counter() - t
    ck_dir = os.path.join(ROOT, "build", "dp_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    card_dir, host_dir = (os.path.join(ck_dir, d) for d in ("card", "host"))
    try:
        t1 = time.perf_counter()
        save_stacked(card_dir, 1, ez_w, [0, 1], metadata={"arch": ARCH})
        split["save_from_card_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        host_w = tree_map(lambda x: x.cpu(), ez_w)
        save_stacked(host_dir, 1, host_w, [0, 1], metadata={"arch": ARCH})
        split["copy_and_save_from_host_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        same_files = dir_bytes_equal(card_dir, host_dir)
        split["compare_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        row = tree_map(lambda x: x[0], ez_w)
        back, _, meta = restore_stacked(card_dir, row, [0, 1, 2])
        torch.cuda.synchronize()
        split["restore_s"] = time.perf_counter() - t1
    finally:
        t1 = time.perf_counter()
        shutil.rmtree(ck_dir, ignore_errors=True)
        split["remove_s"] = time.perf_counter() - t1
    ok_rows = same_tree_bits(torch, tree_map(lambda x: x[:2], back), ez_w)
    joiner = tree_map(lambda x: DP.worker_mean(x).to(x.dtype), ez_w)
    ok_join = same_tree_bits(torch, tree_map(lambda x: x[2], back), joiner)
    on_card = all(x.is_cuda for x in tree_leaves(back))
    if not (same_files and ok_rows and ok_join and on_card
            and meta == {"arch": ARCH, "worker_ids": [0, 1]}):
        fail(f"dp stacked checkpoint: files equal to the host save "
             f"{same_files}, survivors bit-equal {ok_rows}, joiner the "
             f"mean {ok_join}, on the card {on_card}, metadata {meta}")
    reshard_s = time.perf_counter() - t
    nbytes = sum(x.numel() * 4 for x in tree_leaves(ez_w))
    out["reshard"] = {"bytes_stored": nbytes, "seconds": reshard_s,
                      "split_s": split}
    print(f"dp reshard [{card}]: stacked {cfg.param_dtype} params [0, 1] "
          f"-> [1, 2] (survivor bit-equal, joiner the fp32 mean cast "
          f"back); save_stacked from the card ({nbytes / 1e9:.2f} GB as "
          f"stored) byte-identical to the save of the same rows on the "
          f"host; restore_stacked onto [0, 1, 2] on the card, survivors "
          f"bit-equal, joiner the mean; {reshard_s:.1f} s "
          f"{json.dumps({k: round(v, 2) for k, v in split.items()})}")
    del back, joiner, row
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the Coordinator over two worker processes -------------------------
    trace = FailureTrace([TraceEvent(2, "fail", 1), TraceEvent(4, "join", 5)])
    with Coordinator(SimTransport(trace), W, heartbeat_timeout=3) as c:
        for s in range(COORD_STEPS):
            c.advance(s)
        sim_log = c.transition_log()
    t = time.perf_counter()
    proc = ProcTransport(inject=trace)
    with Coordinator(proc, W, heartbeat_timeout=3) as c:
        start_s = time.perf_counter() - t
        t = time.perf_counter()
        for s in range(COORD_STEPS):
            c.advance(s)
        drive_s = time.perf_counter() - t
        proc_log = c.transition_log()
        alive = c.alive()
        devices = proc.host_devices()
        placed = c.place_rows(host_w, list(alive))
        on_card = all(x.is_cuda for x in tree_leaves(placed))
        ok_place = same_tree_bits(torch, placed, ez_w)
    if proc_log != sim_log:
        fail(f"dp coordinator: ProcTransport log {proc_log} != "
             f"SimTransport's {sim_log}")
    if not (on_card and ok_place):
        fail(f"dp coordinator: place_rows on the card {on_card}, values "
             f"unchanged {ok_place} (host devices {devices})")
    out["coordinator"] = {"log": proc_log, "alive": list(alive),
                          "start_s": start_s, "drive_s": drive_s,
                          "devices": {w: str(d) for w, d in devices.items()}}
    print(f"dp coordinator [{card}]: ProcTransport, {W} worker processes, "
          f"trace fail 1 @2, join @4: transition log equal to "
          f"SimTransport's ({len(proc_log)} transitions, alive "
          f"{list(alive)}); children started in {start_s:.2f} s, "
          f"{COORD_STEPS} steps driven in {drive_s:.2f} s; place_rows put "
          f"the stacked params on {sorted({str(d) for d in devices.values()})}"
          f", values unchanged")
    del ez_w, host_w, placed
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"dp [{card}]: phase 7 took {out['seconds']:.1f} s")
    return out


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
    qwen3-0.6b drafting (k 3; its widths, DRAFT_LAYERS layers); then that
    draft drafting for itself on 4 requests, which must accept all k in
    at least one round."""
    from repro_torch.models.config import param_count
    from repro_torch.serving import (LookupDraft, ModelDraft, Request,
                                     ServeEngine, SpecDecodeEngine)
    tcfg = kernel_cfg(TARGET)
    dcfg = kernel_cfg(ARCH).with_(num_layers=DRAFT_LAYERS)
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
    print(f"spec [{card}]: {ARCH} at {dcfg.num_layers} layers drafting "
          f"for itself, "
          f"{SELF_DRAFT_REQUESTS} requests: rounds={st['spec_rounds']} "
          f"accept_rate={st['accept_rate']:.3f} "
          f"tokens/round={st['tokens_per_round']:.3f} full-accept "
          f"row-rounds={st['spec_full_accepts']}, worst near-argmax gap "
          f"{gap:.4f}, launches={launches}")
    del dparams
    torch.cuda.empty_cache()
    total, _ = param_count(tcfg)
    return {"target": TARGET, "target_params": total, "draft": ARCH,
            "draft_layers": DRAFT_LAYERS,
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
      its largest entry (the layers' differences compound through the
      layers and the prompt's tokens: 0.048 through all 24 on an H100 at
      700 W)."""
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
        why = ("for time: its recurrence runs a token at a time"
               if arch == RWKV else f"its {full / 1e9:.1f}B params at full "
               f"depth do not fit one card")
        cut = (f", depth cut to {depth} of {full_layers} layers ({why})"
               if depth else "")
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


# ---------------------------------------------------------------------------
# phase 8: elastic training
# ---------------------------------------------------------------------------
def equals_saved(torch, ckpt_dir, step, tree):
    """Every leaf of `tree` bit-equal to checkpoint `step` read back from
    `ckpt_dir`, a leaf at a time (bf16 leaves are stored as float32)."""
    import numpy as np
    from repro_torch.checkpoint.ckpt import _flatten
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    for key, t in _flatten(tree).items():
        saved = torch.from_numpy(np.load(os.path.join(d, f"{key}.npy")))
        if saved.shape != t.shape or not torch.equal(
                bits(torch, saved.to(t.dtype)), bits(torch, t.cpu())):
            return False
    return True


def elastic_phase(torch, card, ops, NC):
    """Phase 8: qwen3-0.6b at full width, its depth cut to EL_LAYERS
    (bf16, block remat, AdamW), trained by
    `repro_torch.launch.train.train([... "--elastic" ...])`.
    (a) sync over EL_W workers with compressed gradients and asynchronous
    saves, worker 1 killed at wall EL_FAIL_AT: the restore of step 4 (2
    steps lost) bit-equal to the save read back from disk, final_alive
    (0, 2, 3), EL_STEPS finite losses, nc_pack / nc_unpack launched one a
    gradient leaf a step actually run (the redone ones included) and no
    other kernel, then one step's compressed gradients through the kernels
    and the plain versions bit-identical; (b, c) local_sgd and async_ps,
    worker 1 killed at wall EL_LOCAL_FAIL: no step lost, final_alive (0,),
    finite losses, no kernel launched; (d) run_elastic on the card against
    the CPU in every mode (transitions, recoveries, simulated time and
    goodput equal, losses at rtol 1e-5 / atol 1e-8), and a sync run over
    ProcTransport worker processes equal to its SimTransport run.  The
    checkpoints are deleted at the end."""
    import gc
    import shutil
    from repro_torch import obs
    from repro_torch.cluster import ProcTransport
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.elastic import (ElasticProblem, FailureTrace,
                                     run_elastic)
    from repro_torch.elastic import recovery as RC
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import train
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves
    t_phase = time.perf_counter()
    cfg = get_config(ARCH).with_(num_layers=EL_LAYERS)
    n_leaves = len(tree_leaves(MD.model_descs(cfg)))
    base = os.path.join(ROOT, "build", "elastic_smoke")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    out = {}
    names = ("nc_pack", "nc_unpack", "flash_attention", "paged_attention",
             "ssd_scan")

    def trace_file(name, step):
        path = os.path.join(base, name)
        with open(path, "w") as fh:
            json.dump([{"step": step, "kind": "fail", "worker": 1}], fh)
        return path

    def launcher(argv):
        """One launcher run from zeroed counters and peak, recorded."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        rec = obs.Recorder()
        t = time.perf_counter()
        with obs.recording(rec):
            res = train(argv + ["--layers", str(EL_LAYERS),
                                "--log-every", "1000"])
        torch.cuda.synchronize()
        return (res, rec, time.perf_counter() - t,
                {n: getattr(ops, n).launches for n in names},
                torch.cuda.max_memory_allocated() / 1e9)

    try:
        # (a) sync: checkpoint, kill, restore, rewind ---------------------
        ckpt_dir = os.path.join(base, "ckpt")
        real_recover = RC.SyncCheckpointRestore.recover
        restored = {}

        def checked_recover(self, params, opt_state):
            torch.cuda.synchronize()
            t = time.perf_counter()
            p, o, step = real_recover(self, params, opt_state)
            torch.cuda.synchronize()
            restored.update(step=step, seconds=time.perf_counter() - t,
                            equal=equals_saved(torch, self.ckpt_dir, step,
                                               {"params": p}))
            return p, o, step

        RC.SyncCheckpointRestore.recover = checked_recover
        try:
            res, rec, wall, launches, peak = launcher([
                "--elastic", "--mode", "sync", "--workers", str(EL_W),
                "--batch", str(EL_BATCH), "--seq", str(EL_SEQ),
                "--steps", str(EL_STEPS), "--compress-grads",
                "--ckpt-dir", ckpt_dir, "--ckpt-every", str(EL_CKPT_EVERY),
                "--keep-last", str(EL_KEEP),
                "--failure-trace", trace_file("sync.json", EL_FAIL_AT)])
        finally:
            RC.SyncCheckpointRestore.recover = real_recover
        recs = [(r.wall_step, r.worker, r.cause, r.lost_steps)
                for r in res["recoveries"]]
        lost = EL_FAIL_AT - (EL_FAIL_AT // EL_CKPT_EVERY) * EL_CKPT_EVERY
        if recs != [(EL_FAIL_AT, 1, "fail", lost)] or \
                restored.get("step") != EL_FAIL_AT - lost:
            fail(f"elastic sync: recoveries {recs}, restored step "
                 f"{restored.get('step')}")
        if tuple(res["final_alive"]) != (0, 2, 3):
            fail(f"elastic sync: final_alive {res['final_alive']}")
        losses = res["losses"]
        if len(losses) != EL_STEPS or not finite(losses):
            fail(f"elastic sync: losses {losses}")
        if not restored["equal"]:
            fail("elastic sync: the params just after the restore differ "
                 "from the save read back")
        spans = {}
        for e in rec.events:
            spans.setdefault(e.name, []).append(1e3 * e.dur)
        run = len(spans.get("lm.step", ()))
        want = n_leaves * run
        if run != EL_STEPS + lost or launches["nc_pack"] != want or \
                launches["nc_unpack"] != want or any(
                    launches[n] for n in names[2:]):
            fail(f"elastic sync: {run} steps run, launches {launches}, "
                 f"want {want} nc_pack and nc_unpack ({n_leaves} leaves "
                 f"x {run} steps) and nothing else")
        step_ms = spans["lm.step"]
        b = {k: torch.from_numpy(v).cuda() for k, v in next(iter(
            make_pipeline(cfg.vocab_size, EL_BATCH, EL_SEQ, seed=1))).items()}
        _, grads = loss_and_grads(res["params"], cfg, b)
        n, nonfinite = leafwise_roundtrip_check(torch, ops, NC, grads,
                                                seed=EL_STEPS + 1)
        final_alive = tuple(res["final_alive"])
        transitions = res["transitions"]
        del res, grads, b
        timed = sorted(step_ms[1:])
        out["sync"] = {
            "recoveries": recs, "restored_step": restored["step"],
            "restore_s": restored["seconds"], "losses": losses,
            "steps_run": run, "launches": launches, "step_ms": step_ms,
            "ms_per_step": sum(timed) / len(timed),
            "save_pause_ms": spans.get("ckpt.snapshot", []),
            "recovery_span_ms": spans.get("recovery", []),
            "peak_mem_gb": peak, "wall_s": wall, "grad_elements": n,
            "grad_nonfinite": nonfinite, "final_alive": final_alive,
            "transitions": transitions}
        print(f"elastic sync [{card}]: {ARCH} bf16 at {EL_LAYERS} layers, "
              f"{EL_W} workers x "
              f"{EL_BATCH // EL_W} x seq {EL_SEQ}, compressed gradients, a "
              f"save every {EL_CKPT_EVERY} steps (keep {EL_KEEP}), worker 1 "
              f"killed at wall {EL_FAIL_AT}: restored step "
              f"{restored['step']} in {restored['seconds']:.2f} s (bit-equal "
              f"to the save read back), {lost} steps lost, final_alive "
              f"{final_alive}, {run} steps run at "
              f"{out['sync']['ms_per_step']:.1f} ms/step (median "
              f"{timed[len(timed) // 2]:.1f}, max {timed[-1]:.1f}), save "
              f"pauses (ckpt.snapshot) "
              f"{[round(x, 1) for x in out['sync']['save_pause_ms']]} ms, "
              f"peak memory {peak:.2f} GB, launches {launches}, losses "
              f"{[round(x, 4) for x in losses]}; one step's compressed "
              f"gradients, kernels vs plain: bit-identical; {wall:.1f} s")

        # (b, c) local_sgd and async_ps: a death costs no step -------------
        for mode in ("local_sgd", "async_ps"):
            res, rec, wall, launches, peak = launcher([
                "--elastic", "--mode", mode, "--workers", str(EL_LOCAL_W),
                "--batch", str(EL_LOCAL_BATCH), "--seq", str(EL_LOCAL_SEQ),
                "--steps", str(EL_LOCAL_STEPS),
                "--failure-trace", trace_file(f"{mode}.json",
                                              EL_LOCAL_FAIL)])
            losses = res["losses"]
            lost = [r.lost_steps for r in res["recoveries"]]
            if lost != [0] or tuple(res["final_alive"]) != (0,):
                fail(f"elastic {mode}: lost steps {lost}, final_alive "
                     f"{res['final_alive']}")
            if len(losses) != EL_LOCAL_STEPS or not finite(losses):
                fail(f"elastic {mode}: losses {losses}")
            if any(launches.values()):
                fail(f"elastic {mode}: a kernel launched: {launches}")
            transitions = res["transitions"]
            del res
            spans = {}
            for e in rec.events:
                if e.ph == "X":
                    spans[e.name] = spans.get(e.name, 0.0) + e.dur
            out[mode] = {"losses": losses, "lost_steps": lost,
                         "peak_mem_gb": peak, "wall_s": wall,
                         "span_s": spans, "transitions": transitions}
            print(f"elastic {mode} [{card}]: {ARCH} bf16 at {EL_LAYERS} "
                  f"layers, {EL_LOCAL_W} "
                  f"workers, batch {EL_LOCAL_BATCH} x seq {EL_LOCAL_SEQ}, "
                  f"{EL_LOCAL_STEPS} steps, worker 1 killed at wall "
                  f"{EL_LOCAL_FAIL}: lost steps {lost}, final_alive (0,), "
                  f"losses {[round(x, 4) for x in losses]}, peak memory "
                  f"{peak:.2f} GB, {wall:.1f} s (spans, s: "
                  f"{json.dumps({k: round(v, 2) for k, v in spans.items()})})")

        # (d) run_elastic on the card against the CPU -----------------------
        sim = {}
        for mode in ELASTIC_MODES:
            runs, secs = {}, {}
            for dev in ("cpu", "cuda"):
                t = time.perf_counter()
                runs[dev] = run_elastic(
                    ElasticProblem(device=dev), mode=mode,
                    steps=EL_SIM_STEPS,
                    trace=FailureTrace.single_failure(EL_SIM_FAIL, 1),
                    ckpt_dir=os.path.join(base, f"{mode}_{dev}"))
                secs[dev] = time.perf_counter() - t
            c, g = runs["cpu"], runs["cuda"]
            same = ([x.as_tuple() for x in g.transitions]
                    == [x.as_tuple() for x in c.transitions]
                    and [(r.wall_step, r.worker, r.cause, r.lost_steps,
                          r.latency) for r in g.recoveries]
                    == [(r.wall_step, r.worker, r.cause, r.lost_steps,
                         r.latency) for r in c.recoveries]
                    and (g.sim_time, g.goodput, g.samples, g.final_alive)
                    == (c.sim_time, c.goodput, c.samples, c.final_alive))
            err = max(abs(a - b) / max(abs(b), 1e-3)
                      for a, b in zip(g.losses, c.losses))
            close = len(g.losses) == len(c.losses) and all(
                abs(a - b) <= 1e-8 + 1e-5 * abs(b)
                for a, b in zip(g.losses, c.losses))
            if not (same and close):
                fail(f"run_elastic {mode}: the card's run differs from the "
                     f"CPU's (clock equal {same}, losses close {close})")
            sim[mode] = {"sim_time": g.sim_time, "goodput": g.goodput,
                         "lost": [r.lost_steps for r in g.recoveries],
                         "loss_err": err, "cuda_s": secs["cuda"],
                         "cpu_s": secs["cpu"], "final_loss": g.final_loss}
        t = time.perf_counter()
        proc = run_elastic(
            ElasticProblem(device="cuda"), mode="sync", steps=EL_SIM_STEPS,
            transport=ProcTransport(
                inject=FailureTrace.single_failure(EL_SIM_FAIL, 1),
                device="cuda"),
            ckpt_dir=os.path.join(base, "sync_proc"))
        proc_s = time.perf_counter() - t
        ref = run_elastic(ElasticProblem(device="cuda"), mode="sync",
                          steps=EL_SIM_STEPS,
                          trace=FailureTrace.single_failure(EL_SIM_FAIL, 1),
                          ckpt_dir=os.path.join(base, "sync_sim"))
        if ([x.as_tuple() for x in proc.transitions]
                != [x.as_tuple() for x in ref.transitions]
                or proc.losses != ref.losses
                or proc.final_loss != ref.final_loss
                or proc.sim_time != ref.sim_time):
            fail("run_elastic sync over ProcTransport differs from its "
                 "SimTransport run")
        sim["sync_proc_s"] = proc_s
        out["run_elastic"] = sim
        print(f"elastic run_elastic [{card}]: least squares, "
              f"{EL_SIM_STEPS} steps, worker 1 killed at {EL_SIM_FAIL}, "
              f"card vs CPU: transitions, recoveries, sim_time and goodput "
              f"equal, losses within 1e-5 in every mode "
              f"({json.dumps({m: {k: round(v, 6) if isinstance(v, float) else v for k, v in r.items()} for m, r in sim.items() if m in ELASTIC_MODES})}); "
              f"sync over ProcTransport equal to SimTransport ("
              f"{proc_s:.2f} s)")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"elastic [{card}]: phase 8 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 9: the serving fleet
# ---------------------------------------------------------------------------
def fleet_phase(torch, card, ops, MD):
    """Phase 9: FLEET_REPLICAS replicas of qwen3-0.6b at full width (bf16,
    one param set, one ServeProgram) served by
    `repro_torch.launch.serve.serve([... "--replicas" ...])` on phase 4's
    request shapes through the paged engine.  A failure-free run, then the
    same stream with replica FLEET_VICTIM killed mid-stream: every request
    finished once with its full budget, one drain, each of the victim's
    requests re-admitted by KV migration (migrated_admits == readmitted),
    each installed page and row read back bit-equal, no preemption, and
    flash and paged launched one a layer an admit and a decode tick over
    the fleet's engines (the killed one's included); the stitched streams
    equal to the failure-free run's (else the share of equal tokens is
    reported and the comparison gated in fp32 at FLEET_FP32_LAYERS
    layers).  Then a hedged fleet whose replica FLEET_HUNG hangs: at
    least one hedge, each request delivered exactly once, every hedge
    resolved, launches exact."""
    import argparse
    import gc
    import shutil
    import numpy as np
    from repro_torch.launch.serve import _make_stream, serve
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.serving import ServeEngine, ServeFleet
    t_phase = time.perf_counter()
    cfg = kernel_cfg(ARCH)
    L = cfg.num_layers
    base = os.path.join(ROOT, "build", "fleet_smoke")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    argv = ["--continuous", "--paged", "--replicas", str(FLEET_REPLICAS),
            "--requests", str(REQUESTS), "--batch", str(SLOTS),
            "--prompt-len", str(PLEN[1]), "--gen", str(GEN[1]),
            "--page-size", str(PAGE)]
    stream = _make_stream(cfg, argparse.Namespace(
        seed=0, prompt_len=PLEN[1], gen=GEN[1], requests=REQUESTS),
        torch.device("cpu"))
    budget = {r.rid: r.max_new_tokens for r in stream}
    names = ("flash_attention", "paged_attention", "ssd_scan")
    out = {}

    def trace_file(name, kind, worker, step):
        path = os.path.join(base, name)
        with open(path, "w") as fh:
            json.dump([{"step": step, "kind": kind, "worker": worker}], fh)
        return path

    def run(what, extra=()):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t = time.perf_counter()
        res = serve(argv + list(extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {n: getattr(ops, n).launches for n in names}
        es = res["engine_stats"]
        want = {"flash_attention": L * es["prefill_ticks"],
                "paged_attention": L * es["decode_ticks"], "ssd_scan": 0}
        if launches != want:
            fail(f"fleet {what}: launches {launches}, want {want} "
                 f"({es['prefill_ticks']} admits with a prefill, "
                 f"{es['decode_ticks']} decode ticks)")
        fins = res["finished"]
        if [f.rid for f in fins] != sorted(budget):
            fail(f"fleet {what}: finished {[f.rid for f in fins]}")
        for f in fins:
            if len(f.tokens) != budget[f.rid]:
                fail(f"fleet {what}: request {f.rid} finished with "
                     f"{len(f.tokens)} tokens, budget {budget[f.rid]}")
        st = res["stats"]
        rec = {"stats": st, "engine_stats": es, "launches": launches,
               "wall_s": wall, "tok_s": st["delivered_tokens"] / wall,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"fleet {what} [{card}]: {ARCH} bf16, {FLEET_REPLICAS} "
              f"replicas x {SLOTS} slots, {REQUESTS} requests: "
              f"{st['delivered_tokens']} tokens in {wall:.2f} s = "
              f"{rec['tok_s']:.1f} tok/s, {st['wall']} wall ticks, drains "
              f"{st['drains']}, readmitted {st['readmitted']}, migrated "
              f"admits {st['migrated_admits']}, preemptions "
              f"{st['preemptions']}, routed {st['routed']}, peak memory "
              f"{rec['peak_mem_gb']:.2f} GB, launches {launches}")
        return fins, rec

    # the failure-free run, watched a wall tick at a time: the first tick
    # from FLEET_MIN_WALL on where the victim's every request has emitted
    # and none is queued or waits for its first token
    real_step = ServeFleet.step
    watch = []

    def watched(self):
        real_step(self)
        state = {}
        for rid, rep in self.replicas.items():
            eng = rep.engine
            act = [int(s) for s in np.flatnonzero(eng.pool.active)]
            state[rid] = (len(act), eng.scheduler.pending == 0
                          and not eng._pending_first
                          and all(eng.pool.generated[s] for s in act))
        watch.append((self.wall, state))
    ServeFleet.step = watched
    try:
        free, out["failure_free"] = run("failure-free")
    finally:
        ServeFleet.step = real_step
    last = watch[-1][0]
    kill = next((w for w, st in watch if w >= FLEET_MIN_WALL
                 and st[FLEET_VICTIM][0] >= 2 and st[FLEET_VICTIM][1]), None)
    hang = next((w for w, st in watch if w >= FLEET_MIN_WALL
                 and st[FLEET_HUNG][0] >= 1), None)
    if kill is None or hang is None or kill > last // 2:
        fail(f"fleet: no mid-stream wall tick to kill replica "
             f"{FLEET_VICTIM} at ({kill}) or hang replica {FLEET_HUNG} at "
             f"({hang}) in {last} ticks")

    # the kill: each install read back right after it
    real_install = ServeEngine._admit_migrated
    installs = []

    def read_back(self, req, slot):
        real_install(self, req, slot)
        kv = req.kv_seed
        n = next(iter(kv.pages.values())).shape[1]
        ids = torch.as_tensor(self.pages.owned[slot][:n],
                              device=self.device).long()
        held = {k: self.cache[k][:, ids].cpu() for k in kv.pages}
        rows = {k: tree_map(lambda t: t[:, slot].cpu(), self.cache[k])
                for k in kv.rows}
        installs.append(all(
            torch.equal(bits(torch, h), bits(torch, k)) for h, k in zip(
                tree_leaves(held) + tree_leaves(rows),
                tree_leaves(kv.pages) + tree_leaves(kv.rows))))
    ServeEngine._admit_migrated = read_back
    try:
        fins, out["killed"] = run(f"replica {FLEET_VICTIM} killed at wall "
                                  f"{kill}", ["--failure-trace", trace_file(
                                      "kill.json", "fail", FLEET_VICTIM,
                                      kill)])
    finally:
        ServeEngine._admit_migrated = real_install
    st = out["killed"]["stats"]
    if st["drains"] != 1 or st["preemptions"]:
        fail(f"fleet kill: drains {st['drains']}, preemptions "
             f"{st['preemptions']}")
    if not (st["migrated_admits"] == st["readmitted"] == len(installs) >= 2):
        fail(f"fleet kill: migrated admits {st['migrated_admits']}, "
             f"readmitted {st['readmitted']}, installs {len(installs)}")
    if not all(installs):
        fail("fleet kill: an installed page or row differs from its "
             "harvest")
    share = same_share(fins, free)
    out["killed"].update(kill_wall=kill, same_token_share=share,
                         tokens=[list(f.tokens) for f in fins])
    if share != 1.0:
        out["fp32"] = fleet_fp32(torch, MD, stream, kill)
    print(f"fleet kill [{card}]: replica {FLEET_VICTIM} killed at wall "
          f"{kill} of {out['failure_free']['stats']['wall']}: "
          f"{st['readmitted']} requests re-admitted, all by KV migration, "
          f"{len(installs)} installs read back bit-equal, no preemption; "
          f"stitched tokens equal to the failure-free run's: {share:.4f}"
          + ("" if share == 1.0 else " (fp32 at "
             f"{FLEET_FP32_LAYERS} layers: equal)"))

    # hedged decode through the backup role ------------------------------
    hfins, out["hedged"] = run(
        f"hedged, replica {FLEET_HUNG} hung at wall {hang}",
        ["--hedged", "--failure-trace",
         trace_file("hang.json", "hang", FLEET_HUNG, hang)])
    hs = out["hedged"]["stats"]
    keys = ("hedges_launched", "hedges_won_primary", "hedges_won_backup")
    if not all(k in hs for k in keys) or hs["hedges_launched"] < 1 or \
            hs["hedges_won_primary"] + hs["hedges_won_backup"] != \
            hs["hedges_launched"] or hs["finished"] != REQUESTS:
        fail(f"fleet hedged: {json.dumps({k: hs.get(k) for k in keys + ('finished',)})}")
    out["hedged"].update(hang_wall=hang,
                         same_token_share=same_share(hfins, free))
    print(f"fleet hedged [{card}]: replica {FLEET_HUNG} hung at wall {hang}"
          f": {hs['hedges_launched']} hedges launched, "
          f"{hs['hedges_won_primary']} won by the primary, "
          f"{hs['hedges_won_backup']} by the backup; every request "
          f"delivered once; tokens equal to the failure-free run's "
          f"{out['hedged']['same_token_share']:.4f} (a hedge re-prefills)")
    shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"fleet [{card}]: phase 9 took {out['seconds']:.1f} s")
    return out


def fleet_fp32(torch, MD, stream, kill):
    """The kill's comparison once more in fp32 with the depth cut to
    FLEET_FP32_LAYERS (the kernels on): the stitched streams must equal
    the failure-free fleet's."""
    from repro_torch.elastic import FailureTrace, TraceEvent
    from repro_torch.serving import Request, ServeFleet
    cfg = kernel_cfg(ARCH).with_(num_layers=FLEET_FP32_LAYERS,
                                 param_dtype="float32",
                                 compute_dtype="float32")
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))

    def fleet(trace):
        f = ServeFleet(params, cfg, replicas=FLEET_REPLICAS,
                       num_slots=SLOTS, cache_len=PLEN[1] + GEN[1],
                       page_size=PAGE, trace=trace, device="cuda")
        return f.run([Request(rid=r.rid, prompt=r.prompt,
                              max_new_tokens=r.max_new_tokens)
                      for r in stream]), f.stats()
    free, _ = fleet(None)
    fins, st = fleet(FailureTrace([TraceEvent(kill, "fail", FLEET_VICTIM)]))
    share = same_share(fins, free)
    if share != 1.0 or st["migrated_admits"] != st["readmitted"]:
        fail(f"fleet fp32 ({FLEET_FP32_LAYERS} layers): tokens equal "
             f"{share}, migrated admits {st['migrated_admits']}, "
             f"readmitted {st['readmitted']}")
    del params
    torch.cuda.empty_cache()
    return {"layers": FLEET_FP32_LAYERS, "same_token_share": share}


# ---------------------------------------------------------------------------
# phase 10: model parallelism and the mesh, on a world of one
# ---------------------------------------------------------------------------
def mesh_phase(torch, card, ops, train_ms, elastic, fleet):
    """qwen3-0.6b at full width on a world of one: an NCCL group of one
    rank (a file:// store) and `make_device_mesh(1, 1)`.

    10a. for each of the train launcher's envs (dp, tp, dp_tp, fsdp) one
         train step at phase 6's shape (batch 2 x 4096, compressed
         gradients, in place) from the same state as the plain unsharded
         step: parameters, moments, loss and gnorm bit-equal, nc_pack /
         nc_unpack launched once a gradient leaf; then a second step
         timed, beside phase 6's ms a step;
    10b. a tp prefill with use_flash_kernel: logits and cache bit-equal
         to the unsharded prefill's, one flash launch a layer;
    10c. DDG over the 28 layers as K = 4 modules of 7 (the embedding in
         module 0, the final norm and lm_head in module 3), one batch of
         2 x 1024 for DDG_TICKS ticks: active_modules follows JAX's fill
         (0 at the first tick, rising to K), every loss finite and the
         loss falling; and K = 1 at 2 layers bit-equal to sequential_step;
    10d. pipeline_apply at S = 1 over the 28 blocks bit-equal to
         sequential_apply (M = 1), and at M = PP_M to sequential_apply of
         each microbatch; bubble_fraction(4, 8) printed;
    10e. at MESH_STATE_LAYERS layers, the dp_tp mesh state after a step
         saved blocking and through AsyncCheckpointer, byte-identical to
         the plain state's save, restored into the mesh layout bit-equal
         with its placements, and stepped from the restore bit-equal to
         the unbroken state's step;
    10f. one Adafactor step under dp_tp bit-equal to the plain one;
    10g. the elastic launcher on the mesh over --transport proc, held to
         phase 8's plain runs (`elastic`);
    10h. the proc fleet on the mesh, held to phase 9's killed run
         (`fleet`)."""
    import logging
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.train import ENVS
    cfg = get_config(ARCH)
    t_phase = time.perf_counter()
    out = {}
    # DTensor's notes on per-dim collectives are not the phase's output
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    torch.cuda.set_device(0)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_device_mesh(1, 1)
            out["train"] = mesh_train(torch, card, ops, cfg, mesh, ENVS,
                                      train_ms)
            out["prefill"] = mesh_prefill(torch, card, ops, cfg, mesh)
            out["ddg"] = ddg_phase(torch, card, cfg)
            out["pp"] = pp_phase(torch, card, cfg)
            out["state"] = mesh_state(torch, card, ops, mesh, tmp)
            out["adafactor"] = mesh_adafactor(torch, card, ops, mesh)
            out["elastic"] = mesh_elastic(torch, card, ops, mesh, elastic)
            out["fleet"] = mesh_fleet(torch, card, ops, mesh, fleet)
        finally:
            dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"mesh [{card}]: phase 10 took {out['seconds']:.1f} s")
    return out


def mesh_train(torch, card, ops, cfg, mesh, envs, train_ms):
    from repro_torch.core import sharding as SH
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import batch_pspecs, make_train_step
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.optimizers import adamw, warmup_cosine

    B, S = TRAIN_BATCH, TRAIN_SEQ
    params0 = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_leaves = len(tree_leaves(params0))
    opt = adamw(warmup_cosine(3e-3, TRAIN_WARMUP, 1 + TRAIN_STEPS))
    step_fn = make_train_step(cfg, opt, compress_grads=True)
    batches = iter(make_pipeline(cfg.vocab_size, B, S, seed=0))
    data = [{k: torch.from_numpy(v).cuda() for k, v in
             next(batches).items()} for _ in range(2)]

    def noise(step):
        return torch.Generator(device="cuda").manual_seed(1 + step)

    def fresh():
        return tree_map(torch.clone, params0)

    def local(tree):
        return tree_map(lambda t: t.to_local() if SH.is_dtensor(t) else t,
                        tree)

    plain_p = fresh()
    plain_p, plain_s, plain_m = step_fn(plain_p, opt.init(plain_p), data[0],
                                        noise(0))
    out = {"envs": {}, "n_leaves": n_leaves}
    for name, env in envs.items():
        with SH.axis_env(env):
            p = MD.distribute_params(fresh(), cfg, mesh)
            st = opt.init(p)
            with SH.use_mesh(mesh):
                specs = batch_pspecs(cfg, data[0])
                bs = [{k: SH.distribute(v, specs[k], mesh)
                       for k, v in b.items()} for b in data]
                ops.reset_launches()
                p, st, m = step_fn(p, st, bs[0], noise(0))
                launches = {n: getattr(ops, n).launches
                            for n in ("nc_pack", "nc_unpack")}
                same = {
                    "params": same_tree_bits(torch, local(p), plain_p),
                    "mu": same_tree_bits(torch, local(st["mu"]),
                                         plain_s["mu"]),
                    "nu": same_tree_bits(torch, local(st["nu"]),
                                         plain_s["nu"]),
                    "loss": same_tree_bits(torch, m["loss"],
                                           plain_m["loss"]),
                    "gnorm": same_tree_bits(torch, m["gnorm"],
                                            plain_m["gnorm"])}
                if not all(same.values()):
                    fail(f"mesh train {name}: not bit-equal to the "
                         f"unsharded step: {same} (loss {float(m['loss'])!r}"
                         f" against {float(plain_m['loss'])!r})")
                if any(v != n_leaves for v in launches.values()):
                    fail(f"mesh train {name}: nc launches {launches}, "
                         f"want {n_leaves} each")
                placed = {k: str(tuple(v.placements)) for k, v in
                          (("embed", p["embed"]),
                           ("blocks.attn.wq", p["blocks"]["attn"]["wq"]))}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, st, m2 = step_fn(p, st, bs[1], noise(1))
                loss2 = float(m2["loss"])
                ms = 1e3 * (time.perf_counter() - t0)
                # both steps' launches: the path's count
                launches = {n: getattr(ops, n).launches for n in launches}
                if any(v != 2 * n_leaves for v in launches.values()):
                    fail(f"mesh train {name}: nc launches {launches} over "
                         f"two steps, want {2 * n_leaves} each")
            del p, st, bs
        out["envs"][name] = {"ms": ms, "launches": launches,
                             "loss": float(m["loss"]), "loss2": loss2,
                             "placements": placed}
        print(f"mesh train [{card}]: {name} on a 1x1 mesh ({placed}), "
              f"batch {B} x {S}: params, moments, loss and gnorm "
              f"bit-equal to the unsharded step, nc launches {launches} "
              f"over two steps; the second {ms:.1f} ms (phase 6: "
              f"{train_ms:.1f} ms/step)")
    return out


def mesh_prefill(torch, card, ops, cfg, mesh):
    from repro_torch.core import sharding as SH
    from repro_torch.models import model as MD
    cfg = kernel_cfg(cfg.name)
    plen = PLEN[1]
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, plen), generator=g,
                           device="cuda")
    C = plen + GEN[1]
    with torch.no_grad():
        ops.reset_launches()
        logits0, _, cache0 = MD.forward(params, cfg, tokens,
                                        return_cache=True, cache_len=C)
        plain_flash = ops.flash_attention.launches
        with SH.axis_env(SH.TP_ENV):
            dparams = MD.distribute_params(params, cfg, mesh)
            with SH.use_mesh(mesh):
                tok = SH.distribute(tokens, SH.logical("batch", None), mesh)
                ops.reset_launches()
                logits, _, cache = MD.forward(dparams, cfg, tok,
                                              return_cache=True,
                                              cache_len=C)
                flash = ops.flash_attention.launches
                logits = SH.whole(logits)
    want = cfg.num_layers if cfg.use_flash_kernel else 0
    if flash != want or plain_flash != want:
        fail(f"mesh prefill: flash launches {flash} (unsharded "
             f"{plain_flash}), want {want}")
    if not (same_tree_bits(torch, logits, logits0)
            and same_tree_bits(torch, cache, cache0)):
        fail("mesh prefill: logits or cache differ from the unsharded "
             "prefill's")
    print(f"mesh prefill [{card}]: tp on a 1x1 mesh, a {plen}-token "
          f"prompt: logits and cache bit-equal to the unsharded prefill, "
          f"{flash} flash launches")
    return {"launches": {"flash_attention": flash}, "prompt": plen}


def _state_setup(torch, opt_fn):
    """qwen3-0.6b's widths at MESH_STATE_LAYERS layers: the config, the
    seed-0 weights, the optimizer, the compressed train step, phase 6's
    first two batches on the card and the noise of step i."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as MD
    from repro_torch.optim.optimizers import warmup_cosine
    cfg = get_config(ARCH).with_(num_layers=MESH_STATE_LAYERS)
    params0 = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = opt_fn(warmup_cosine(3e-3, TRAIN_WARMUP, 1 + TRAIN_STEPS))
    batches = iter(make_pipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                 seed=0))
    data = [{k: torch.from_numpy(v).cuda() for k, v in
             next(batches).items()} for _ in range(2)]
    return (cfg, params0, opt, make_train_step(cfg, opt, compress_grads=True),
            data, lambda i: torch.Generator(device="cuda").manual_seed(1 + i))


def _on_dp_tp(torch, cfg, params0, opt, data, mesh):
    """The seed weights and a fresh state laid out under DP_TP_ENV, and
    the batches split (call under the env and the mesh)."""
    from repro_torch.core import sharding as SH
    from repro_torch.launch.steps import batch_pspecs
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_map
    p = MD.distribute_params(tree_map(torch.clone, params0), cfg, mesh)
    specs = batch_pspecs(cfg, data[0])
    return p, opt.init(p), [{k: SH.distribute(v, specs[k], mesh)
                             for k, v in b.items()} for b in data]


def _locals(tree):
    from repro_torch.core import sharding as SH
    from repro_torch.models.common import tree_map
    return tree_map(SH.local, tree)


def mesh_state(torch, card, ops, mesh, tmp):
    """10e: the dp_tp mesh state's save, restore and resumed step."""
    import shutil

    from repro_torch.checkpoint import (AsyncCheckpointer,
                                        restore_checkpoint, save_checkpoint)
    from repro_torch.core import sharding as SH
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.optimizers import adamw
    t_phase = time.perf_counter()
    cfg, params0, opt, step_fn, data, noise = _state_setup(torch, adamw)
    n = len(tree_leaves(params0))
    meta = {"step": 1, "arch": ARCH}
    dirs = {k: os.path.join(tmp, k) for k in ("plain", "mesh", "async")}
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        return out

    p = tree_map(torch.clone, params0)
    p, st, _ = step_fn(p, opt.init(p), data[0], noise(0))
    plain = {"params": p, "opt": st}
    timed("plain save", lambda: save_checkpoint(dirs["plain"], 1, plain,
                                                meta))
    del plain, p, st
    try:
        with SH.axis_env(SH.DP_TP_ENV), SH.use_mesh(mesh):
            pd, sd, bs = _on_dp_tp(torch, cfg, params0, opt, data, mesh)
            ops.reset_launches()
            pd, sd, _ = step_fn(pd, sd, bs[0], noise(0))
            tree = {"params": pd, "opt": sd}
            timed("mesh save", lambda: save_checkpoint(dirs["mesh"], 1,
                                                       tree, meta))
            with AsyncCheckpointer(dirs["async"]) as ck:
                timed("async snapshot", lambda: ck.save(1, tree, meta))
                timed("async wait", ck.wait)
            same = {k: dir_bytes_equal(dirs["plain"], dirs[k])
                    for k in ("mesh", "async")}
            if not all(same.values()):
                fail(f"mesh state: saves of the dp_tp state differ from "
                     f"the plain state's save: {same}")
            back, got = timed("restore", lambda: restore_checkpoint(
                dirs["mesh"], tree_map(torch.zeros_like, tree)))
            placed = all(a.placements == b.placements for a, b in
                         zip(tree_leaves(back), tree_leaves(tree))
                         if SH.is_dtensor(b))
            if got != meta or not placed or not same_tree_bits(
                    torch, _locals(back), _locals(tree)):
                fail(f"mesh state: the restore into the mesh layout "
                     f"differs (metadata {got}, placements kept: "
                     f"{placed})")
            pr, sr, mr = step_fn(back["params"], back["opt"], bs[1],
                                 noise(1))
            pd, sd, md = step_fn(pd, sd, bs[1], noise(1))
            launches = {k: getattr(ops, k).launches
                        for k in ("nc_pack", "nc_unpack")}
            if not same_tree_bits(
                    torch, _locals({"p": pr, "s": sr, "l": mr["loss"]}),
                    _locals({"p": pd, "s": sd, "l": md["loss"]})):
                fail("mesh state: the step from the restore differs from "
                     "the unbroken state's step")
            size = sum(os.path.getsize(os.path.join(dirs["mesh"], r, f))
                       for r, _, fs in os.walk(dirs["mesh"]) for f in fs)
    finally:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    if any(v != 3 * n for v in launches.values()):
        fail(f"mesh state: nc launches {launches} over three mesh steps, "
             f"want {3 * n} each")
    out = {"seconds": time.perf_counter() - t_phase, "launches": launches,
           "stored_gb": size / 1e9, "layers": cfg.num_layers,
           "times_s": secs}
    print(f"mesh state [{card}]: {ARCH} widths at {cfg.num_layers} of 28 "
          f"layers, dp_tp on a 1x1 mesh after a compressed AdamW step "
          f"({out['stored_gb']:.2f} GB as stored): saved blocking and "
          f"asynchronously byte-identical to the plain state's save, "
          f"restored bit-equal with its placements, the next step from "
          f"the restore bit-equal to the unbroken one; nc launches "
          f"{launches}; seconds "
          f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}, "
          f"{out['seconds']:.1f} in all")
    return out


def mesh_adafactor(torch, card, ops, mesh):
    """10f: one compressed Adafactor step under dp_tp against the plain
    one: parameters, statistics and loss bit-equal."""
    from repro_torch.core import sharding as SH
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.optimizers import adafactor
    t_phase = time.perf_counter()
    cfg, params0, opt, step_fn, data, noise = _state_setup(torch, adafactor)
    n = len(tree_leaves(params0))
    p = tree_map(torch.clone, params0)
    p, st, m = step_fn(p, opt.init(p), data[0], noise(0))
    with SH.axis_env(SH.DP_TP_ENV), SH.use_mesh(mesh):
        pd, sd, bs = _on_dp_tp(torch, cfg, params0, opt, data, mesh)
        ops.reset_launches()
        pd, sd, md = step_fn(pd, sd, bs[0], noise(0))
        launches = {k: getattr(ops, k).launches
                    for k in ("nc_pack", "nc_unpack")}
        same = {"params": same_tree_bits(torch, _locals(pd), p),
                "statistics": same_tree_bits(torch, _locals(sd["f"]),
                                             st["f"]),
                "loss": same_tree_bits(torch, md["loss"], m["loss"])}
    if not all(same.values()):
        fail(f"mesh adafactor: the dp_tp step is not bit-equal to the "
             f"plain one: {same}")
    if any(v != n for v in launches.values()):
        fail(f"mesh adafactor: nc launches {launches}, want {n} each")
    out = {"seconds": time.perf_counter() - t_phase, "launches": launches,
           "loss": float(m["loss"])}
    print(f"mesh adafactor [{card}]: {ARCH} widths at {cfg.num_layers} "
          f"layers, one compressed Adafactor step under dp_tp on a 1x1 "
          f"mesh: parameters, statistics and loss bit-equal to the plain "
          f"step; nc launches {launches}; {out['seconds']:.1f} s")
    return out


def mesh_elastic(torch, card, ops, mesh, plain):
    """10g: `launch.train._train(args, mesh)` with --elastic at phase 8's
    shapes and kills, on the 1x1 mesh: over --transport proc (worker
    processes) sync with --compress-grads --async-ckpt and local_sgd,
    then async_ps over sim.  Each run's recoveries, final_alive and transitions are
    phase 8's plain run's, its losses bit-equal (sync: the restored step
    too; nc_pack / nc_unpack one a gradient leaf a step run, the redone
    ones included; local_sgd and async_ps: no kernel)."""
    import gc
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.elastic import recovery as RC
    from repro_torch.launch import train as T
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves
    t_phase = time.perf_counter()
    n_leaves = len(tree_leaves(MD.model_descs(
        get_config(ARCH).with_(num_layers=EL_LAYERS))))
    base = os.path.join(ROOT, "build", "mesh_elastic")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    out = {}

    def run(mode, fail_at, argv, transport="proc"):
        trace = os.path.join(base, f"{mode}.json")
        with open(trace, "w") as fh:
            json.dump([{"step": fail_at, "kind": "fail", "worker": 1}], fh)
        args = T.parse_args(argv + [
            "--elastic", "--mode", mode, "--transport", transport,
            "--failure-trace", trace, "--layers", str(EL_LAYERS),
            "--log-every", "1000", "--data", "1", "--model", "1"])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        res = T._train(args, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {n: getattr(ops, n).launches for n in KERNEL_NAMES}
        ref = plain[mode]
        recs = [(r.wall_step, r.worker, r.cause, r.lost_steps)
                for r in res["recoveries"]]
        want_recs = ref["recoveries"] if mode == "sync" else [
            (fail_at, 1, "fail", 0)]
        if recs != want_recs or res["transitions"] != ref["transitions"] \
                or tuple(res["final_alive"]) != (
                    ref["final_alive"] if mode == "sync" else (0,)):
            fail(f"mesh elastic {mode}: recoveries {recs}, final_alive "
                 f"{res['final_alive']}, transitions {res['transitions']}; "
                 f"phase 8's {want_recs}, {ref['transitions']}")
        if res["losses"] != ref["losses"]:
            err = max(abs(a - b) / abs(b)
                      for a, b in zip(res["losses"], ref["losses"]))
            fail(f"mesh elastic {mode}: losses {res['losses']} not "
                 f"bit-equal to phase 8's {ref['losses']} (max relative "
                 f"difference {err:.3g})")
        del res
        return {"recoveries": recs, "launches": launches, "wall_s": wall}

    try:
        # sync: the restore read back as phase 8 reads it
        real_recover = RC.SyncCheckpointRestore.recover
        restored = {}

        def checked_recover(self, params, opt_state):
            p, o, step = real_recover(self, params, opt_state)
            restored.update(step=step, equal=equals_saved(
                torch, self.ckpt_dir, step, {"params": _locals(p)}))
            return p, o, step
        RC.SyncCheckpointRestore.recover = checked_recover
        try:
            out["sync"] = run("sync", EL_FAIL_AT, [
                "--workers", str(EL_W), "--batch", str(EL_BATCH), "--seq",
                str(EL_SEQ), "--steps", str(EL_STEPS), "--compress-grads",
                "--async-ckpt", "--ckpt-dir", os.path.join(base, "ckpt"),
                "--ckpt-every", str(EL_CKPT_EVERY), "--keep-last",
                str(EL_KEEP)])
        finally:
            RC.SyncCheckpointRestore.recover = real_recover
        ref = plain["sync"]
        launches = out["sync"]["launches"]
        want = n_leaves * ref["steps_run"]
        if restored.get("step") != ref["restored_step"] or \
                not restored["equal"]:
            fail(f"mesh elastic sync: restored {restored}, phase 8 "
                 f"restored step {ref['restored_step']}")
        if launches["nc_pack"] != want or launches["nc_unpack"] != want \
                or any(launches[n] for n in KERNEL_NAMES[:3]):
            fail(f"mesh elastic sync: launches {launches}, want {want} "
                 f"nc_pack and nc_unpack ({n_leaves} leaves x "
                 f"{ref['steps_run']} steps run) and nothing else")
        print(f"mesh elastic sync [{card}]: {ARCH} bf16 at {EL_LAYERS} "
              f"layers through `launch.train._train(args, mesh)` --elastic "
              f"--transport proc --compress-grads --async-ckpt on the 1x1 "
              f"mesh, worker 1 killed at wall {EL_FAIL_AT}: restored step "
              f"{restored['step']} (bit-equal to the save read back), "
              f"recoveries, transitions, final_alive and {EL_STEPS} losses "
              f"bit-equal to phase 8's plain run; launches {launches}; "
              f"{out['sync']['wall_s']:.1f} s (phase 8: "
              f"{ref['wall_s']:.1f} s)")
        # async_ps over sim: over proc each push and pull carries the
        # whole model (218M fp32 entries, the embedding 71% of them) as
        # base64 JSON through a worker's pipe, about half a minute each
        for mode, transport in (("local_sgd", "proc"), ("async_ps", "sim")):
            out[mode] = run(mode, EL_LOCAL_FAIL, [
                "--workers", str(EL_LOCAL_W), "--batch",
                str(EL_LOCAL_BATCH), "--seq", str(EL_LOCAL_SEQ), "--steps",
                str(EL_LOCAL_STEPS)], transport)
            if any(out[mode]["launches"].values()):
                fail(f"mesh elastic {mode}: a kernel launched: "
                     f"{out[mode]['launches']}")
            print(f"mesh elastic {mode} [{card}]: {ARCH} bf16 at "
                  f"{EL_LAYERS} layers over --transport {transport} on the 1x1 "
                  f"mesh, worker 1 killed at wall {EL_LOCAL_FAIL}: no step "
                  f"lost, transitions and {EL_LOCAL_STEPS} losses "
                  f"bit-equal to phase 8's plain run; "
                  f"{out[mode]['wall_s']:.1f} s (phase 8: "
                  f"{plain[mode]['wall_s']:.1f} s)")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def mesh_fleet(torch, card, ops, mesh, fleet9):
    """10h: phase 9's killed run again through `serve(... "--replicas",
    "--transport", "proc", "--paged" ..., mesh=mesh)` on the 1x1 mesh:
    every request finished once with its full budget, one drain, the
    streams phase 9's, flash and paged launched one a layer an admit and
    a decode tick; tokens/s beside phase 9's."""
    import argparse
    import gc
    from repro_torch.launch.serve import _make_stream, serve
    t_phase = time.perf_counter()
    cfg = kernel_cfg(ARCH)
    L = cfg.num_layers
    killed = fleet9["killed"]
    stream = _make_stream(cfg, argparse.Namespace(
        seed=0, prompt_len=PLEN[1], gen=GEN[1], requests=REQUESTS),
        torch.device("cpu"))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    trace = os.path.join(ROOT, "build", "mesh_fleet_kill.json")
    with open(trace, "w") as fh:
        json.dump([{"step": killed["kill_wall"], "kind": "fail",
                    "worker": FLEET_VICTIM}], fh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    res = serve(["--continuous", "--paged", "--replicas",
                 str(FLEET_REPLICAS), "--requests", str(REQUESTS),
                 "--batch", str(SLOTS), "--prompt-len", str(PLEN[1]),
                 "--gen", str(GEN[1]), "--page-size", str(PAGE),
                 "--transport", "proc", "--failure-trace", trace,
                 "--data", "1", "--model", "1"], mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    os.remove(trace)
    launches = {n: getattr(ops, n).launches for n in
                ("flash_attention", "paged_attention", "ssd_scan")}
    es, st, fins = res["engine_stats"], res["stats"], res["finished"]
    want = {"flash_attention": L * es["prefill_ticks"],
            "paged_attention": L * es["decode_ticks"], "ssd_scan": 0}
    if launches != want:
        fail(f"mesh fleet: launches {launches}, want {want}")
    if [f.rid for f in fins] != [r.rid for r in stream] or any(
            len(f.tokens) != r.max_new_tokens for f, r in zip(fins, stream)):
        fail("mesh fleet: a request did not finish once with its budget")
    if st["drains"] != 1 or len(res["worker_pids"]) != FLEET_REPLICAS:
        fail(f"mesh fleet: drains {st['drains']}, worker processes "
             f"{len(res['worker_pids'])}")
    got = [list(f.tokens) for f in fins]
    if got != killed["tokens"]:
        eq = sum(a == b for g, k in zip(got, killed["tokens"])
                 for a, b in zip(g, k))
        fail(f"mesh fleet: streams part from phase 9's killed run ({eq} "
             f"of {sum(map(len, killed['tokens']))} tokens equal)")
    tok_s = st["delivered_tokens"] / wall
    out = {"launches": launches, "stats": st, "wall_s": wall,
           "tok_s": tok_s, "phase9_tok_s": killed["tok_s"],
           "seconds": time.perf_counter() - t_phase}
    print(f"mesh fleet [{card}]: {ARCH} bf16, {FLEET_REPLICAS} replicas "
          f"over --transport proc ({len(res['worker_pids'])} worker "
          f"processes) on the 1x1 mesh, replica {FLEET_VICTIM} killed at "
          f"wall {killed['kill_wall']}: {st['delivered_tokens']} tokens in "
          f"{wall:.2f} s = {tok_s:.1f} tok/s (phase 9's killed run: "
          f"{killed['tok_s']:.1f}), one drain, {st['readmitted']} "
          f"re-admitted, streams equal to phase 9's; launches {launches}")
    return out


def _ddg_modules(torch, cfg, params, K):
    """qwen3's stack as K modules of L/K layers: module 0 starts with the
    embedding lookup, module K-1 ends with the final norm and lm_head.
    Returns (per-module params, fns)."""
    from repro_torch.models import model as MD
    from repro_torch.models.common import (dense, embed_lookup, rms_norm,
                                           torch_dtype, tree_map)
    L = cfg.num_layers
    per = L // K
    mods = []
    for k in range(K):
        pk = {"blocks": tree_map(lambda t: t[k * per:(k + 1) * per].clone(),
                                 params["blocks"])}
        if k == 0:
            pk["embed"] = params["embed"].clone()
        if k == K - 1:
            pk["final_norm"] = params["final_norm"].clone()
            pk["lm_head"] = params["lm_head"].clone()
        mods.append(pk)

    def make(k):
        def fn(p, x):
            if k == 0:
                x = embed_lookup(p["embed"], x).to(
                    torch_dtype(cfg.compute_dtype))
            B, S = x.shape[:2]
            pos = torch.arange(S, device=x.device)[None].expand(B, S)
            for i in range(per):
                lp = tree_map(lambda t: t[i], p["blocks"])
                x = MD._block(lp, x, pos, cfg)[0]
            if k == K - 1:
                x = dense(rms_norm(x, p["final_norm"], cfg.norm_eps),
                          p["lm_head"])
            return x
        return fn
    return mods, [make(k) for k in range(K)]


def _ddg_loss(torch):
    def loss_fn(logits, batch):
        logits = logits.float()
        gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        return (torch.logsumexp(logits, -1) - gold).mean()
    return loss_fn


def ddg_phase(torch, card, cfg):
    from repro_torch.core import decoupled as DD
    from repro_torch.data import make_pipeline
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves
    B, S = DDG_B, DDG_S
    # fp32 weights (bf16 compute): SGD steps this small vanish in bf16
    cfg = cfg.with_(param_dtype="float32", remat="none")
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    b = next(iter(make_pipeline(cfg.vocab_size, B, S, seed=0)))
    batch = {"x": torch.from_numpy(b["tokens"]).cuda(),
             "labels": torch.from_numpy(b["labels"]).cuda()}
    loss_fn = _ddg_loss(torch)
    mods, fns = _ddg_modules(torch, cfg, params, DDG_K)
    del params
    state = DD.ddg_init(mods)
    actives, losses = [], []
    t0 = time.perf_counter()
    for _ in range(DDG_TICKS):
        state, m = DD.ddg_tick(state, fns, loss_fn, batch, lr=DDG_LR)
        actives.append(m["active_modules"])
        losses.append(None if m["loss"] is None else float(m["loss"]))
    torch.cuda.synchronize()
    tick_ms = 1e3 * (time.perf_counter() - t0) / DDG_TICKS
    K = DDG_K
    # JAX's fill: none at first, the head from tick K-1, one more module
    # a tick after, never falling, all K at the end
    fill = [max(0, t - (K - 2)) if t >= K - 1 else 0
            for t in range(DDG_TICKS)]
    fill = [min(K, f) for f in fill]
    got = [x for x in losses if x is not None]
    if actives != fill:
        fail(f"ddg: active_modules {actives}, want {fill}")
    if not got or not all(x == x and abs(x) != float("inf") for x in got):
        fail(f"ddg: non-finite or missing losses {losses}")
    if not got[-1] < got[0]:
        fail(f"ddg: the loss did not fall: {got}")
    del state, mods
    # K = 1 at 2 layers: no staleness, joint backprop bit for bit
    c2 = cfg.with_(num_layers=2)
    p2 = MD.init_model(c2, torch.Generator(device="cuda").manual_seed(1))
    m1, f1 = _ddg_modules(torch, c2, p2, 1)
    st1 = DD.ddg_init(m1)
    seq = [dict(m1[0])]
    for _ in range(3):
        st1, _ = DD.ddg_tick(st1, f1, loss_fn, batch, lr=DDG_LR)
        seq, _ = DD.sequential_step(seq, f1, loss_fn, batch, lr=DDG_LR)
    if not same_tree_bits(torch, st1.params[0], seq[0]):
        fail("ddg: K = 1 differs from sequential_step")
    print(f"ddg [{card}]: {cfg.num_layers} layers as {K} modules, batch "
          f"{B} x {S}, {DDG_TICKS} ticks ({tick_ms:.1f} ms a tick): "
          f"active_modules {actives}, losses "
          f"{[round(x, 4) for x in got]}; K = 1 at 2 layers bit-equal to "
          f"sequential_step over 3 steps ({len(tree_leaves(seq[0]))} "
          f"leaves)")
    return {"actives": actives, "losses": losses, "tick_ms": tick_ms}


def pp_phase(torch, card, cfg):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.pipeline import (bubble_fraction, pipeline_apply,
                                           sequential_apply)
    from repro_torch.models import model as MD
    from repro_torch.models.common import embed_lookup, torch_dtype
    B, S = PP_B, PP_S
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device="cuda")
    x = embed_lookup(params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    smesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))

    def block_fn(lp, h):
        pos = torch.arange(h.shape[1], device=h.device)[None].expand(
            h.shape[0], h.shape[1])
        return MD._block(lp, h, pos, cfg)[0]

    with torch.no_grad():
        seq = sequential_apply(block_fn, params["blocks"], x)
        y1 = pipeline_apply(block_fn, params["blocks"], x, smesh,
                            num_microbatches=1)
        yM = pipeline_apply(block_fn, params["blocks"], x, smesh,
                            num_microbatches=PP_M)
        per_mb = torch.cat([sequential_apply(block_fn, params["blocks"], xm)
                            for xm in x.chunk(PP_M)])
    if not same_tree_bits(torch, y1, seq):
        fail("pipeline_apply at S = 1, M = 1 differs from sequential_apply")
    if not same_tree_bits(torch, yM, per_mb):
        fail(f"pipeline_apply at S = 1, M = {PP_M} differs from "
             f"sequential_apply of each microbatch")
    diff = float((yM.float() - seq.float()).abs().max())
    bub = bubble_fraction(4, 8)
    print(f"pp [{card}]: pipeline_apply over {cfg.num_layers} blocks at "
          f"S = 1, batch {B} x {S}: bit-equal to sequential_apply (M = 1) "
          f"and to it a microbatch (M = {PP_M}; against the whole batch "
          f"max|diff| {diff:.3g}); bubble_fraction(S 4, M 8) = {bub:.4f}")
    return {"m_diff": diff, "bubble_4_8": bub}


# ---------------------------------------------------------------------------
# phases 11 and 12: deep RL and classic ML (no kernel on these paths)
# ---------------------------------------------------------------------------
def launch_counts(ops):
    return {n: getattr(ops, n).launches for n in KERNEL_NAMES}


def to_device(tree, dev):
    from repro_torch.rl.agents import tree_map
    return tree_map(lambda t: t.to(dev) if hasattr(t, "to") else t, tree)


def check_tree_close(torch, what, got, ref, rtol, atol=None):
    """Each leaf |got - ref| <= rtol * |ref| + atol, atol rtol * max|ref|
    unless given; the worst ratio of error to that bound."""
    from repro_torch.rl.agents import tree_leaves
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        bound = rtol * b.abs() + (rtol * b.abs().max() if atol is None
                                  else atol)
        err = (a - b).abs()
        if not bool((err <= bound).all()):
            fail(f"{what}: max|err| {float(err.max()):.3g} beyond rtol "
                 f"{rtol} (largest element {float(b.abs().max()):.3g})")
        worst = max(worst, float((err / bound.clamp(min=1e-30)).max()))
    return worst


def rl_round(arch, state, draws, dev):
    """One round of `arch` from `state` with `draws`, both moved to dev:
    (params, env states, loss, replay actions or None)."""
    from repro_torch.rl import agents as A
    from repro_torch.rl.env import ChainEnv
    env = ChainEnv()
    state, draws = to_device(state, dev), to_device(draws, dev)
    if arch in ("gorila", "apex"):
        new, m = A.gorila_round(state, draws, env=env,
                                prioritized=arch == "apex")
        return (new.params, new.env_states, m["loss"],
                new.replay.storage["action"])
    params, env_states = state
    fn = {"a3c": A.a3c_round, "dppo": A.dppo_round}.get(arch)
    if fn is not None:
        params, env_states, m = fn(params, env_states, draws, env=env)
    else:
        params, env_states, m = A.impala_round(params, params, env_states,
                                               draws, env=env)
    return params, env_states, m["loss"], None


def rl_phase(torch, card, ops):
    """Phase 11: deep RL on the card.

    11a. `repro_torch.launch.rl.rl()` at its defaults, then with actor 1
         killed at wall RL_KILL_AT under sim (recorded) and under proc:
         the proc run's losses, transitions and final params equal the
         sim run's float for float, the goodput ratio is exactly
         1 - (steps - RL_KILL_AT) / (actors * steps), and the events carry
         the JAX package's names on its lanes.
    11b. GORILA, Ape-X, A3C, IMPALA and DPPO one round each over RL_CMP_W
         workers on the card and on the CPU from the same state and the
         same host-drawn draws: params within fp32 2e-5, env states (and
         the replay's actions) equal.
    11c. IMPALA and A3C over RL_BIG_W workers, GORILA over RL_BIG_ACTORS
         actors with an RL_BIG_CAP-slot replay, hidden RL_BIG_HIDDEN:
         ms a round and env steps/s over RL_TIMED rounds, finite losses.
    No kernel launches anywhere in the phase."""
    import math
    from repro_torch.launch.rl import rl
    from repro_torch.obs import recorder as obs
    from repro_torch.obs.trace import write_trace
    from repro_torch.rl import agents as A
    from repro_torch.rl import fleet as F
    from repro_torch.rl.env import ChainEnv, gumbel
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts(ops)
    base = os.path.join(ROOT, "build", "rl_smoke")
    os.makedirs(base, exist_ok=True)
    kill = os.path.join(base, "kill.json")
    with open(kill, "w") as fh:
        json.dump([{"step": RL_KILL_AT, "kind": "fail", "worker": 1}], fh)
    out = {}

    # 11a: the launcher; each run_fleet result kept for its params
    fleets, real = [], F.run_fleet

    def keep(**kw):
        fleets.append(real(**kw))
        return fleets[-1]
    F.run_fleet = keep
    try:
        runs = {}
        for name, extra in (("free", []), ("kill_sim", ["--failure-trace",
                                                         kill]),
                            ("kill_proc", ["--failure-trace", kill,
                                           "--transport", "proc"])):
            t0 = time.perf_counter()
            if name == "kill_sim":
                with obs.recording(obs.Recorder()) as rec:
                    runs[name] = rl(["--device", "cuda"] + extra)
                events = rec.events
            else:
                runs[name] = rl(["--device", "cuda"] + extra)
            runs[name]["seconds"] = time.perf_counter() - t0
    finally:
        F.run_fleet = real
    free, ksim, kproc = (runs[k] for k in ("free", "kill_sim", "kill_proc"))
    steps, actors = 40, 4
    if not (free["learner_steps"] > 0 and finite(free["losses"])
            and free["goodput"] == actors * 16):
        fail(f"rl: failure-free fleet {free}")
    ratio = ksim["goodput"] / free["goodput"]
    want = 1 - (steps - RL_KILL_AT) / (actors * steps)
    if abs(ratio - want) > 1e-12:
        fail(f"rl: goodput ratio {ratio} != {want}")
    if kproc["losses"] != ksim["losses"] or \
            kproc["transitions"] != ksim["transitions"]:
        fail("rl: the proc fleet's losses or transitions differ from sim's")
    if not same_tree_bits(torch, F._flatten(fleets[2].final_params),
                          F._flatten(fleets[1].final_params)):
        fail("rl: the proc fleet's final params differ from sim's")
    names = {e.name for e in events}
    need = {"actor.rollout", "replay.push", "replay.sample", "replay.update",
            "learner.step", "learner.open", "replay.open",
            "membership.death"}
    lanes = {n: {e.host for e in events if e.name == n}
             for n in ("actor.rollout", "replay.push", "learner.step")}
    if not need <= names or not (
            lanes["actor.rollout"] <= set(range(actors))
            and lanes["replay.push"] <= {"replay4", "replay5"}
            and lanes["learner.step"] == {"learner6"}):
        fail(f"rl: events {sorted(need - names)} missing or lanes {lanes}")
    write_trace(os.path.join(base, "rl_trace.json"), events)
    out["fleet"] = {k: {f: v[f] for f in ("goodput", "learner_steps",
                                          "seconds")}
                    for k, v in runs.items()}
    out["fleet"]["goodput_ratio"] = ratio
    print(f"rl [{card}]: launch.rl defaults {free['seconds']:.1f} s "
          f"(goodput {free['goodput']:.1f}, {free['learner_steps']} learner "
          f"steps, final loss {free['losses'][-1]:.4f}); actor 1 killed at "
          f"{RL_KILL_AT}: sim {ksim['seconds']:.1f} s, proc "
          f"{kproc['seconds']:.1f} s, losses/params/transitions equal, "
          f"goodput ratio {ratio:.5f} (want {want:.5f}), {len(events)} "
          f"events")

    # 11b: one round each, card vs CPU
    env = ChainEnv()
    g = torch.Generator().manual_seed(11)
    W, T = RL_CMP_W, 16
    out["rounds_cmp"] = {}
    for arch in ("gorila", "apex", "a3c", "impala", "dppo"):
        if arch in ("gorila", "apex"):
            state = A.q_init(env, g, actors=W, capacity=4 * W * T)
            state, _ = A.gorila_round(state, g, env=env)
            draws = {"gumbel": gumbel((W, T, 2), g),
                     "uniform": torch.rand(64, generator=g)}
        else:
            state = (A.ac_init(g, env.obs_dim, env.num_actions),
                     env.reset((W,)))
            draws = gumbel((W, T, 2), g)
        cp, cs, cl, ca = rl_round(arch, state, draws, "cpu")
        gp, gs, gl, ga = rl_round(arch, state, draws, "cuda")
        worst = check_tree_close(torch, f"rl {arch} card vs cpu", gp, cp,
                                 2e-5)
        same = all(torch.equal(gs[k].cpu(), cs[k]) for k in ("pos", "t"))
        if ca is not None:
            same = same and torch.equal(ga.cpu(), ca)
        if not same or not math.isfinite(float(gl)):
            fail(f"rl {arch}: env states or actions differ card vs cpu, "
                 f"or loss {float(gl)}")
        out["rounds_cmp"][arch] = {"worst_over_tol": worst,
                                   "loss_gpu": float(gl),
                                   "loss_cpu": float(cl)}
    print(f"rl [{card}]: one round of each architecture over {W} workers, "
          f"card vs cpu: params within 2e-5 (worst at "
          f"{max(r['worst_over_tol'] for r in out['rounds_cmp'].values()):.3f}"
          f" of it), env states equal")

    # 11c: card-sized rounds
    gc_ = torch.Generator(device="cuda").manual_seed(12)
    big = {}
    for arch in ("impala", "a3c", "gorila"):
        if arch == "gorila":
            n = RL_BIG_ACTORS
            state = A.q_init(env, gc_, actors=n, capacity=RL_BIG_CAP,
                             hidden=RL_BIG_HIDDEN)

            def step(s):
                return A.gorila_round(s, gc_, env=env, batch=RL_BIG_BATCH)
        else:
            n = RL_BIG_W
            state = (A.ac_init(gc_, env.obs_dim, env.num_actions,
                               hidden=RL_BIG_HIDDEN),
                     env.reset((n,), "cuda"))
            fn = A.a3c_round if arch == "a3c" else None

            def step(s, fn=fn):
                p, e = s
                if fn is None:
                    p, e, m = A.impala_round(p, p, e, gc_, env=env)
                else:
                    p, e, m = fn(p, e, gc_, env=env)
                return (p, e), m
        state, m = step(state)                      # warm-up
        torch.cuda.synchronize()
        losses = []
        t0 = time.perf_counter()
        for _ in range(RL_TIMED):
            state, m = step(state)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / RL_TIMED
        losses = [float(x) for x in losses]
        if not finite(losses):
            fail(f"rl {arch} at {n} workers: losses {losses}")
        big[arch] = {"workers": n, "ms_per_round": ms,
                     "env_steps_per_s": n * 16 / (ms / 1e3),
                     "losses": losses}
        print(f"rl [{card}]: {arch}_round over {n} workers x hidden "
              f"{RL_BIG_HIDDEN} x rollout 16"
              + (f", replay {RL_BIG_CAP} slots, batch {RL_BIG_BATCH}"
                 if arch == "gorila" else "")
              + f": {ms:.2f} ms a round, {big[arch]['env_steps_per_s']:.0f} "
              f"env steps/s, losses finite")
        del state
    out["big"] = big
    if launch_counts(ops) != before:
        fail(f"rl: kernel launches moved {before} -> {launch_counts(ops)}")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.perf_counter() - t_phase
    print(f"rl [{card}]: phase 11 took {out['seconds']:.1f} s, peak memory "
          f"{out['peak_mem_gb']:.2f} GB, no kernel launched")
    torch.cuda.empty_cache()
    return out


def blob_data(torch, shape, centers, gen, spread=4.0):
    """(W, n, d) points around `centers` random centers (scale `spread`),
    unit noise, drawn from `gen` on its device."""
    W, n, d = shape
    dev = gen.device
    c = torch.randn((centers, d), generator=gen, device=dev) * spread
    x = c[torch.randint(0, centers, (W, n), generator=gen, device=dev)]
    return x.add_(torch.randn((W, n, d), generator=gen, device=dev))


def label_data(torch, shape, gen, sep=2.0):
    """Two blobs labelled +-1 (tests/test_classic.py's, at `shape`), drawn
    from `gen` on its device."""
    W, n, d = shape
    dev = gen.device
    y = torch.where(torch.rand((W, n), generator=gen, device=dev) < 0.5,
                    1.0, -1.0)
    x = torch.randn((W, n, d), generator=gen, device=dev)
    return x.add_(y[..., None] * (sep / d ** 0.5)), y


def classic_runs(torch, gen, device, scale=1, central=True, timed=None):
    """Every classic trainer on `device`, on data drawn from `gen` (on its
    own device), the rows cut by `scale`; with `central` also the
    centralized k-means, SVM and AdaBoost on the pooled data.  `timed`
    (a dict) receives ms an iteration of each."""
    from repro_torch.classic import boosting as B
    from repro_torch.classic import kmeans as K
    from repro_torch.classic import svm as S
    timed = {} if timed is None else timed
    res = {}

    def run(name, iters, fn, nbytes):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        timed[name] = {"ms": (time.perf_counter() - t0) * 1e3 / iters,
                       "bound_ms": nbytes / PEAK_BYTES * 1e3}

    def cut(shape):
        return (shape[0], shape[1] // scale, shape[2])

    def draw(*ts):
        return tuple(t.to(device) for t in ts)
    x, = draw(blob_data(torch, cut(CL_KMEANS), CL_K, gen))
    W, n, d = x.shape
    idx, = draw(torch.randperm(W * n, generator=gen,
                               device=gen.device)[:CL_K])
    nb = x.numel() * 4
    run("kmeans_dist", CL_ITERS,
        lambda: K.kmeans_fit(x, CL_K, CL_ITERS, noise=idx), nb)
    if central:
        run("kmeans_central", CL_ITERS, lambda: K.kmeans_centralized(
            x.reshape(-1, d), CL_K, CL_ITERS, noise=idx), nb)
    del x
    x, y = draw(*label_data(torch, cut(CL_SVM), gen))
    nb = x.numel() * 4
    run("svm_dist", CL_SVM_STEPS,
        lambda: S.svm_dist_gradient(x, y, steps=CL_SVM_STEPS)[0], nb)
    if central:
        run("svm_central", CL_SVM_STEPS, lambda: S.svm_centralized(
            x.reshape(-1, x.shape[2]), y.reshape(-1),
            steps=CL_SVM_STEPS)[0], nb)
    del x, y
    x, y = draw(*label_data(torch, cut(CL_BOOST), gen))
    flat_x, flat_y = x.reshape(-1, x.shape[2]), y.reshape(-1)
    nb = x.numel() * 4
    grid = B.StumpGrid.from_data(flat_x, 16)
    run("boost_dist", CL_ROUNDS,
        lambda: B.adaboost_dist_full(x, y, CL_ROUNDS, grid), nb)
    run("boost_sample", CL_ROUNDS,
        lambda: B.adaboost_dist_sample(x, y, CL_ROUNDS, grid), nb)
    if central:
        run("boost_central", CL_ROUNDS, lambda: B.adaboost_centralized(
            flat_x, flat_y, CL_ROUNDS, grid), nb)
    res["boost_err"] = {k: float(B.error_rate(res[k], flat_x, flat_y))
                        for k in ("boost_dist", "boost_sample")}
    del x, y, flat_x, flat_y
    x, y = draw(*label_data(torch, cut(CL_DPSVM), gen, sep=2.5))
    nb = x.numel() * 4
    run("dpsvm", CL_HOPS, lambda: S.dpsvm(
        x, y, hops=CL_HOPS, sv_capacity=CL_SV_CAP // scale), nb)
    res["dpsvm_acc"] = float(S.accuracy(res["dpsvm"][0], x.reshape(
        -1, x.shape[2]), y.reshape(-1)))
    del x, y
    x, = draw(blob_data(torch, cut(CL_FUZZY), CL_FUZZY_TRUE, gen))
    flat = x.reshape(-1, x.shape[2])
    res["xie_beni"] = {}
    for k in range(2, 9):
        c = flat[draw(torch.randperm(flat.shape[0], generator=gen,
                                     device=gen.device)[:k])[0]]

        def fuzzy(c=c):
            for _ in range(CL_FUZZY_STEPS):
                c, obj = K.fuzzy_cmeans_step(x, c)
            return c, obj, K.xie_beni(x, c)
        run(f"fuzzy_k{k}", CL_FUZZY_STEPS, fuzzy, x.numel() * 4)
        res["xie_beni"][k] = res.pop(f"fuzzy_k{k}")
    return res


def classic_phase(torch, card, ops):
    """Phase 12: the classic trainers at sizes their users run, on data
    drawn on the card from CL_SEED, with the JAX tests' claims as gates:
    distributed k-means equals centralized (centroids and inertia history
    within rtol 1e-5 of the largest element) and its inertia does not rise
    (1e-6 relative); `adaboost_dist_full` picks the centralized stumps
    with alphas within rtol 1e-5; `svm_dist_gradient` equals
    `svm_centralized` within rtol 1e-4, atol 1e-5 (tests/test_classic.py's
    tolerance); Xie-Beni is least at the CL_FUZZY_TRUE clusters drawn.
    Each trainer's ms an iteration stands beside its bytes bound (x read
    once at the HBM rate).  Then the distributed trainers at 1/CL_SMALL
    of the rows on the card against the CPU from the same host-drawn
    data.  No kernel launches."""
    import math
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts(ops)
    timed = {}
    gen = torch.Generator(device="cuda").manual_seed(CL_SEED)
    r = classic_runs(torch, gen, "cuda", timed=timed)
    (cd, hd), (cc, hc) = r["kmeans_dist"], r["kmeans_central"]
    check_tree_close(torch, "kmeans dist vs central centroids", [cd], [cc],
                     1e-5)
    check_tree_close(torch, "kmeans dist vs central inertia", [hd], [hc],
                     1e-5)
    h = hd.double().cpu()
    if not bool((h[1:] <= h[:-1] * (1 + 1e-6)).all()):
        fail(f"kmeans inertia rose: {h.tolist()}")
    # the weights, as tests/test_classic.py holds them; the bias's gap
    # is reported
    check_tree_close(torch, "svm dist vs central", r["svm_dist"]["w"],
                     r["svm_central"]["w"], 1e-4, atol=1e-5)
    b_gap = abs(float(r["svm_dist"]["b"] - r["svm_central"]["b"]))
    bd, bc = r["boost_dist"], r["boost_central"]
    if not all(torch.equal(bd[k], bc[k]) for k in "dtp"):
        fail("adaboost dist_full picked other stumps than centralized")
    check_tree_close(torch, "adaboost alphas", [bd["alpha"]],
                     [bc["alpha"]], 1e-5)
    pd, info = r["dpsvm"]
    xb = {k: float(v[2]) for k, v in r["xie_beni"].items()}
    # tests/test_classic.py's claim: Xie-Beni is least at the true k
    if not (info["comm_floats"] < info["full_exchange_floats"]
            and all(math.isfinite(v) for v in xb.values())
            and min(xb, key=xb.get) == CL_FUZZY_TRUE
            and math.isfinite(r["dpsvm_acc"])):
        fail(f"dpsvm {info} / xie-beni {xb}")
    for name, t in timed.items():
        print(f"classic [{card}]: {name}: {t['ms']:.3f} ms an iteration, "
              f"bound {t['bound_ms']:.3f} ms (x read once)")
    err = r["boost_err"]
    print(f"classic [{card}]: kmeans {CL_KMEANS} k {CL_K} dist == central, "
          f"inertia {float(h[0]):.6g} -> {float(h[-1]):.6g}; svm "
          f"{CL_SVM} dist == central (the bias {b_gap:.3g} apart); "
          f"adaboost {CL_BOOST} dist_full stumps == central, error "
          f"dist_full {err['boost_dist']:.4f} dist_sample "
          f"{err['boost_sample']:.4f}; dpsvm {CL_DPSVM} accuracy "
          f"{r['dpsvm_acc']:.4f}, comm {info['comm_floats']:.0f} of "
          f"{info['full_exchange_floats']} floats; xie-beni by k "
          f"{json.dumps({k: round(v, 4) for k, v in xb.items()})} (argmin "
          f"{min(xb, key=xb.get)}, {CL_FUZZY_TRUE} true clusters)")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del r
    torch.cuda.empty_cache()

    # card vs CPU at 1/CL_SMALL of the rows, the data drawn on the host
    t0 = time.perf_counter()
    c, g = (classic_runs(torch, torch.Generator().manual_seed(CL_SEED), dev,
                         scale=CL_SMALL, central=False)
            for dev in ("cpu", "cuda"))
    worst = {"kmeans_dist": check_tree_close(
        torch, "kmeans card vs cpu", g["kmeans_dist"], c["kmeans_dist"],
        2e-5), "svm_dist": check_tree_close(
        torch, "svm card vs cpu", g["svm_dist"]["w"], c["svm_dist"]["w"],
        1e-4, atol=1e-5)}
    for key in ("boost_dist", "boost_sample"):
        if not all(torch.equal(g[key][k].cpu(), c[key][k]) for k in "dtp"):
            fail(f"{key}: stumps differ card vs cpu")
        worst[key] = check_tree_close(torch, f"{key} alphas card vs cpu",
                                      [g[key]["alpha"]], [c[key]["alpha"]],
                                      2e-5)
    worst["dpsvm"] = check_tree_close(torch, "dpsvm card vs cpu",
                                      g["dpsvm"][0], c["dpsvm"][0], 1e-4,
                                      atol=1e-5)
    if g["dpsvm"][1] != c["dpsvm"][1]:
        fail(f"dpsvm comm card {g['dpsvm'][1]} vs cpu {c['dpsvm'][1]}")
    for k in range(2, 9):
        # centroids and objective; Xie-Beni only where its denominator,
        # the two nearest centroids' squared distance, is not rounding
        # noise (past the true k two centroids can settle on one cluster)
        gcen, gobj, gxb = g["xie_beni"][k]
        ccen, cobj, cxb = c["xie_beni"][k]
        sep = torch.cdist(ccen.double(), ccen.double()) ** 2
        sep = float(sep[~torch.eye(k, dtype=torch.bool)].min() / sep.max())
        worst[f"fuzzy_k{k}"] = check_tree_close(
            torch, f"fuzzy k {k} card vs cpu",
            [gcen, gobj] + ([gxb] if sep > 1e-6 else []),
            [ccen, cobj] + ([cxb] if sep > 1e-6 else []), 1e-4)
    cmp_s = time.perf_counter() - t0
    print(f"classic [{card}]: the distributed trainers at 1/{CL_SMALL} of "
          f"the rows, card vs cpu from the same data: stumps and SV counts "
          f"equal, "
          f"values within tolerance (worst at "
          f"{max(worst.values()):.3f} of it), {cmp_s:.1f} s")
    if launch_counts(ops) != before:
        fail(f"classic: kernel launches moved {before} -> "
             f"{launch_counts(ops)}")
    out = {"timed": timed, "xie_beni": xb, "worst_over_tol": worst,
           "peak_mem_gb": peak, "seconds": time.perf_counter() - t_phase}
    print(f"classic [{card}]: phase 12 took {out['seconds']:.1f} s, peak "
          f"memory {peak:.2f} GB, no kernel launched")
    return out


# ---------------------------------------------------------------------------
# phase 13: serving under a mesh, the dry run, the roofline
# ---------------------------------------------------------------------------
# share of a counted lower bound in a measured step above which the count
# is wrong (the step cannot beat its bound)
BOUND_SHARE_MAX = 1.05


def mesh_serve_phase(torch, card, ops, phase4, fins4, train_ms, dryrun):
    t_phase = time.perf_counter()
    out = {"serve": mesh_serve(torch, card, ops, phase4, fins4)}
    out["dryrun"] = dryrun_phase(card, dryrun)
    out["roofline"] = roofline_phase(torch, card, train_ms)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"mesh serve [{card}]: phase 13 took {out['seconds']:.1f} s")
    return out


def mesh_serve(torch, card, ops, phase4, fins4):
    """13a: phase 4's requests through the serve launcher on a (1, 1)
    mesh over an NCCL group of one rank, with --trace-out: the trace
    holds one `request` span a request and the engine's `serve.*`
    events, by name, cat and count those of phase 4's recorded run."""
    import logging
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.serve import serve, summary
    from repro_torch.serving import Request
    cfg = kernel_cfg(ARCH)
    reqs = make_requests(cfg, Request)
    argv = ["--arch", ARCH, "--continuous", "--paged", "--page-size",
            str(PAGE), "--batch", str(SLOTS), "--requests", str(REQUESTS),
            "--prompt-len", str(PLEN[1]), "--gen", str(GEN[1]),
            "--data", "1", "--model", "1"]
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    torch.cuda.set_device(0)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_device_mesh(1, 1)
            torch.cuda.synchronize()
            ops.reset_launches()
            res = serve(argv + ["--trace-out", f"{tmp}/trace.json"],
                        mesh=mesh, requests=reqs)
            t_trace = time.perf_counter()
            events = trace_counts(f"{tmp}/trace.json")
            torch.cuda.synchronize()
            launches = {n: getattr(ops, n).launches for n in
                        ("flash_attention", "paged_attention", "ssd_scan")}
            with SH.axis_env(SH.DP_TP_ENV), SH.use_mesh(mesh):
                placed = summary(res)["placements"]
            eng = res["engine"]
            dtensors = [SH.is_dtensor(t) for t in eng.cache.values()]
            del res["engine"], eng
        finally:
            dist.destroy_process_group()
    st, fins = res["stats"], res["finished"]
    want = want_launches(cfg, st)
    if launches != want:
        fail(f"mesh serve: launches {launches}, want {want} "
             f"({st['prefill_ticks']} admits, {st['decode_ticks']} decode "
             f"ticks)")
    if not all(dtensors) or any(got != want_pl for got, want_pl, _ in placed):
        fail(f"mesh serve: pools {placed} (DTensors: {dtensors}), not as "
             f"cache_pspecs(serve=True) places them")
    same = same_share(fins, fins4)
    if [f.tokens for f in fins] != [f.tokens for f in fins4]:
        fail(f"mesh serve: the streams part from phase 4's ({same:.4f} of "
             f"the tokens equal)")
    names = {}
    for (name, _), k in events.items():
        names[name] = names.get(name, 0) + k
    if names.get("request") != len(reqs) or not any(
            n.startswith("serve.") for n in names):
        fail(f"mesh serve: trace events {names}, want one request span "
             f"for each of {len(reqs)} requests and the serve.* events")
    rec4 = phase4.get("recorded")
    if rec4 and events != trace_counts(rec4["trace"]):
        fail(f"mesh serve: trace events {sorted(events.items())} differ "
             f"from phase 4's recorded run's "
             f"{sorted(trace_counts(rec4['trace']).items())}")
    trace_s = time.perf_counter() - t_trace
    print(f"mesh serve trace [{card}]: rank 0's trace holds "
          f"{json.dumps(names)} (cats "
          f"{sorted({c for _, c in events})}), "
          f"{'as phase 4 recorded' if rec4 else 'no recorded run to match'}")
    tps = st["generated_tokens"] / res["t_total"]
    tick_ms = 1e3 * res["t_total"] / st["decode_ticks"]
    p4 = phase4["stats"]
    p4_tick_ms = 1e3 * p4["wall_s"] / p4["decode_ticks"]
    print(f"mesh serve [{card}]: {ARCH} through `launch.serve --continuous "
          f"--paged --data 1 --model 1` on an NCCL world of one: "
          f"{st['generated_tokens']} tokens in {res['t_total']:.2f} s = "
          f"{tps:.1f} tok/s (phase 4, warm: {p4['tok_s']:.1f}), wall "
          f"{tick_ms:.2f} ms a decode tick, admits included (phase 4: "
          f"{p4_tick_ms:.2f}), admits={st['prefill_ticks']} "
          f"decode_ticks={st['decode_ticks']} launches={launches}; streams "
          f"equal to phase 4's; pools {[p[0] for p in placed]}")
    return {"launches": launches, "stats": st, "tok_s": tps,
            "tick_ms": tick_ms, "phase4_tok_s": p4["tok_s"],
            "phase4_tick_ms": p4_tick_ms, "placements": placed,
            "trace_events": names, "trace_s": trace_s}


def trace_counts(path):
    """{(name, cat): count} of a written trace's events, metadata left
    out."""
    with open(path) as fh:
        evs = json.load(fh)["traceEvents"]
    out = {}
    for e in evs:
        if e["ph"] != "M":
            key = (e["name"], e.get("cat"))
            out[key] = out.get(key, 0) + 1
    return out


def start_dryrun(out_dir):
    """13b's subprocess, started early: the dry run of qwen3-0.6b on the
    (32, 8) fake mesh, which sees no card.  It is killed at exit if it
    still runs, and its output goes to `out_dir/dryrun/log.txt`."""
    import atexit
    dest = os.path.join(out_dir, "dryrun")
    os.makedirs(dest, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    log = open(os.path.join(dest, "log.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", "all", "--mesh", "single", "--out", dest],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return {"proc": proc, "dest": dest, "t0": time.perf_counter()}


def dryrun_phase(card, started):
    """13b: the dry run's records, from the subprocess `start_dryrun`
    began beside phase 6 (the seconds from its start until read here)."""
    proc, dest = started["proc"], started["dest"]
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    secs = time.perf_counter() - started["t0"]
    if proc.returncode:
        with open(os.path.join(dest, "log.txt")) as fh:
            fail(f"dry run: exit {proc.returncode}: {fh.read()[-2000:]}")
    with open(os.path.join(dest, "dryrun_32x8.json")) as fh:
        recs = json.load(fh)
    for key, rec in sorted(recs.items()):
        if rec["status"] not in ("ok", "skipped"):
            fail(f"dry run {key}: {rec['status']} {rec.get('error')}")
        if rec["status"] == "skipped":
            print(f"dry run {key}: skipped ({rec['reason']})")
            continue
        if not 0 < rec["useful_ratio"] <= 1:
            fail(f"dry run {key}: useful_ratio {rec['useful_ratio']}")
        print(f"dry run {key} on 32x8 (H100 SXM published peaks on counted "
              f"work, no device): t_compute {rec['t_compute']:.4e} s, "
              f"t_memory {rec['t_memory']:.4e} s, t_collective "
              f"{rec['t_collective']:.4e} s, bottleneck {rec['bottleneck']}"
              f", lower bound {rec['step_lower_bound']:.4e} s, useful "
              f"{rec['useful_ratio']:.3f}, peak "
              f"{rec['peak_memory_bytes'] / 1e9:.2f} GB a chip, counted in "
              f"{rec['compile_s']} s")
    print(f"dry run [{card}]: {len(recs)} records, read {secs:.1f} s "
          f"after its start")
    rec = recs[f"{ARCH}|train_4k"]
    before = DRY_TRAIN_4K_BEFORE
    print(f"dry run {ARCH}|train_4k [{card}]: temp "
          f"{rec['temp_bytes'] / 1e9:.2f} GB a chip (before the "
          f"vocab-parallel loss {before['temp_gb']} GB), bytes "
          f"{rec['bytes_per_chip']:.4e} a chip, bound "
          f"{rec['step_lower_bound']:.4f} s (before {before['bound_s']} s)")
    if rec["temp_bytes"] >= CARD_BYTES:
        fail(f"dry run train_4k: temp {rec['temp_bytes'] / 1e9:.2f} GB a "
             f"chip, at or above the card's {CARD_BYTES / 1e9:.0f} GB")
    return {"records": recs, "seconds": secs}


def roofline_phase(torch, card, train_ms):
    """13c: phase 6's step counted on a fake (1, 1) mesh: its lower bound
    against the measured ms a step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import InputShape, get_config
    from repro_torch.core import sharding as SH
    from repro_torch.core.roofline import Roofline, model_flops
    from repro_torch.launch.dryrun import join_fake_world
    from repro_torch.launch.steps import build_plan, cost_plan
    cfg = get_config(ARCH)              # phase 6's: bf16, block remat
    B, S = 2, 4096
    shape = InputShape("phase6", S, B, "train")
    t0 = time.perf_counter()
    join_fake_world(1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        with SH.axis_env(SH.TRAIN_ENV):
            c = cost_plan(build_plan(cfg, shape, mesh), mesh)
    finally:
        dist.destroy_process_group()
    rf = Roofline(ARCH, "phase6", "1x1", 1, float(c["flops"]),
                  float(c["bytes"]), float(c["coll_bytes"]), c["coll_by_op"],
                  model_flops(cfg, S, B, "train"))
    bound_ms = 1e3 * rf.step_time_lower_bound
    share = bound_ms / train_ms
    print(f"roofline [{card}]: {ARCH} train {B} x {S} counted on a fake "
          f"1x1 mesh in {time.perf_counter() - t0:.1f} s: "
          f"{c['flops'] / 1e12:.2f} TFLOP, {c['bytes'] / 1e12:.3f} TB "
          f"(eager, unfused), t_compute {1e3 * rf.t_compute:.1f} ms, "
          f"t_memory {1e3 * rf.t_memory:.1f} ms (H100 SXM published "
          f"peaks), bound {bound_ms:.1f} ms ({rf.bottleneck}), useful "
          f"{rf.useful_ratio:.3f}; phase 6 measured {train_ms:.1f} ms a "
          f"step: the bound is {share:.3f} of it")
    if share > BOUND_SHARE_MAX:
        fail(f"roofline: the bound {bound_ms:.1f} ms exceeds the measured "
             f"step {train_ms:.1f} ms (share {share:.3f}): the count is "
             f"wrong")
    return {"flops": c["flops"], "bytes": c["bytes"], "bound_ms": bound_ms,
            "bottleneck": rf.bottleneck, "measured_ms": train_ms,
            "share": share, "temp_bytes": c["temp_bytes"],
            "argument_bytes": c["argument_bytes"]}


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
    laps, t_lap = {}, [t_start]

    def lap(name):
        """The seconds since the previous lap, kept under `name`."""
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    card = card_line()                                          # phase 1
    print(card)
    # phase 13's dry run joins the fake process group: fail now, not
    # after the other phases, where a torch lacks it
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()                                    # phase 2
    reports = build.build(["flash_attention", "paged_attention",
                           "nat_compress", "ssd_scan"])
    build_s = time.perf_counter() - t0
    print(f"build [{card}]: {build_s:.1f} s")
    lap("1-2 build")
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
    lap("3 checks")

    paths, ample = [], {}
    out_dir = args.out or os.path.join(ROOT, "build")
    for arch in (ARCH, HYBRID):                                 # phase 4
        rec, ample[arch] = serve_path(
            torch, card, arch, ops, MD, SS, ServeEngine, Request,
            args.profile, trace_dir=out_dir if arch == ARCH else None)
        paths.append(rec)
    lap("4 serve")
    spec = spec_phase(torch, card, ops, MD)                     # phase 4b
    lap("4b spec")
    drains = [drain_phase(torch, card, arch, ops, MD, ample[arch])
              for arch in (ARCH, HYBRID)]
    lap("4b drain")
    family = family_phase(torch, card, ops, MD, SS, ServeEngine,  # 4c
                          Request, args.profile)
    lap("4c")
    last = family_phase(torch, card, ops, MD, SS, ServeEngine,    # 4d
                        Request, args.profile, family=LAST, phase="4d")
    swa = swa_phase(torch, card, ops, MD)
    lap("4d")

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
    # and where operations bound it, far above the serve paths' prompts
    timing["flash_attention S=8192"] = time_flash(torch, FA, HEADS[ARCH],
                                                  S=8192)
    timing["ssd_scan"] = time_ssd(torch, SS)
    # zamba2's shorter prompts (3 chunks) and a prompt past any serve
    # path's (16 chunks)
    timing["ssd_scan S=384"] = time_ssd(torch, SS, (1, 384, 64, 64, 64, 128))
    timing["ssd_scan S=2048"] = time_ssd(torch, SS,
                                         (1, 2048, 64, 64, 64, 128))
    for name, t in timing.items():
        lib = ("none" if t["library_ms"] is None else
               f"{t['library']} {t['library_ms']:.4f} ms")
        plan = f" ({t['plan']})" if "plan" in t else ""
        print(f"time [{card}] {name} {t['shape']}{plan}: kernel "
              f"{t['ms']:.4f} ms (a call {t['call_ms']:.4f} ms), "
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
    lap("5 timing")

    # phase 13b's dry run needs no card: it runs beside the train phases
    dryrun = start_dryrun(out_dir)
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
    ckpt = async_ckpt_phase(torch, card, train_cfg,
                            os.path.join(ROOT, "build", "ckpt_smoke"))
    t_fam = time.perf_counter()
    fam_train = family_train_phase(torch, card, ops, NC)
    print(f"train [{card}]: the other families took "
          f"{time.perf_counter() - t_fam:.1f} s")
    lap("6 train")
    dp = dp_phase(torch, card, ops, tr["ms_per_step"])           # phase 7
    lap("7 dp")
    elastic = elastic_phase(torch, card, ops, NC)                # phase 8
    lap("8 elastic")
    fleet = fleet_phase(torch, card, ops, MD)                    # phase 9
    lap("9 fleet")
    mesh = mesh_phase(torch, card, ops, tr["ms_per_step"],      # phase 10
                      elastic, fleet)
    lap("10 mesh")
    laps.update({"10e state (in 10)": round(mesh["state"]["seconds"], 1),
                 "10f adafactor (in 10)":
                     round(mesh["adafactor"]["seconds"], 1),
                 "10g elastic (in 10)": round(mesh["elastic"]["seconds"], 1),
                 "10h fleet (in 10)": round(mesh["fleet"]["seconds"], 1)})
    rl_out = rl_phase(torch, card, ops)                          # phase 11
    lap("11 rl")
    classic = classic_phase(torch, card, ops)                    # phase 12
    lap("12 classic")
    mesh_serve = mesh_serve_phase(torch, card, ops, paths[0],    # phase 13
                                  ample[ARCH], tr["ms_per_step"], dryrun)
    lap("13 mesh serve")
    laps["13a trace (in 13)"] = round(mesh_serve["serve"]["trace_s"], 1)

    # launches by path: each counted from zero over its own main-path run
    by_path = {f"{p['arch']} serve": p["launches"]
               for p in paths + family + last}
    by_path[f"{swa['arch']} prefill"] = swa["launches"]
    by_path.update({f"{p['arch']} serve, tight pool": p["tight_pool"]
                    ["launches"] for p in paths if p["tight_pool"]})
    by_path.update({f"{p['arch']} serve, recorded": p["recorded"]
                    ["launches"] for p in paths if p["recorded"]})
    by_path.update({p: run["launches"] for p, run in spec["runs"].items()})
    for d in drains:
        by_path[f"{d['arch']} drain"] = d["launches_before"]
        by_path[f"{d['arch']} migrated"] = d["launches_after"]
    by_path[f"{ARCH} train"] = {n: tr["launches"][n]
                                for n in ("nc_pack", "nc_unpack")}
    by_path.update({f"{r['arch']} train": {n: r["launches"][n] for n in
                                            ("nc_pack", "nc_unpack")}
                    for r in fam_train})
    by_path[f"{ARCH} elastic"] = {n: elastic["sync"]["launches"][n]
                                  for n in ("nc_pack", "nc_unpack")}
    by_path[f"{ARCH} fleet"] = fleet["killed"]["launches"]
    by_path[f"{ARCH} fleet, hedged"] = fleet["hedged"]["launches"]
    by_path.update({f"{ARCH} mesh train, {env}": r["launches"]
                    for env, r in mesh["train"]["envs"].items()})
    by_path[f"{ARCH} mesh state, dp_tp"] = mesh["state"]["launches"]
    by_path[f"{ARCH} mesh adafactor, dp_tp"] = mesh["adafactor"]["launches"]
    by_path[f"{ARCH} mesh prefill"] = mesh["prefill"]["launches"]
    by_path[f"{ARCH} mesh elastic"] = mesh["elastic"]["sync"]["launches"]
    by_path[f"{ARCH} mesh fleet"] = mesh["fleet"]["launches"]
    by_path[f"{ARCH} mesh serve"] = mesh_serve["serve"]["launches"]
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
              "phase_seconds": laps,
              "checks": rows, "serve": paths, "spec": spec,
              "family": family, "last": last, "swa": swa,
              "drain": drains, "nc_checks": nc_rows,
              "timing": dict(timing, nc=nc_t),
              "train": tr, "async_ckpt": ckpt, "train_families": fam_train,
              "dp": dp, "elastic": elastic, "fleet": fleet, "mesh": mesh,
              "rl": rl_out, "classic": classic, "mesh_serve": mesh_serve}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump(result, fh, indent=1, default=str)
    print(f"phases [{card}]: seconds {json.dumps(laps)}")
    print(f"elapsed [{card}]: {elapsed:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
