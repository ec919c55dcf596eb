"""The paged kernel's plan (`kernels/paged_attention.plan`), on the CPU.

The plan is host arithmetic on the shapes; `block_work` below spells out
the work each block of the grid derives from it and from the rows'
positions, as the kernel (csrc/paged_attention.cu) does from blockIdx.
These tests hold the plan to what the kernel needs: every (table row,
kv-head, query row) in one block of each split, every live page of a
table row read exactly once across its splits and stages by each block
of rows of a KV group (no page past the block's last query's position),
every stage row in exactly one consumer warp's share, and a layout that
fits the card (shared memory, threads, TMA boxes) for every head dim,
group, candidate count and page size in use.  The kernel itself is held against its plain version in
tests/test_torch_cuda.py, on the card.
"""
import itertools
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro_torch.kernels import paged_attention as PA  # noqa: E402

# the timed shapes of chip_smoke.py phase 5, (B, S, Hq, Hk, dh, n_pages,
# P): each serve path's decode at 8 slots on 16-token pages (whisper 28
# pages a slot, phi-3 76), and the verify round (8 slots x 4 candidates)
MAIN = {
    "qwen3-0.6b": (8, 1, 16, 8, 128, 40, 16),
    "zamba2-1.2b": (8, 1, 32, 32, 64, 40, 16),
    "qwen3-moe-30b-a3b": (8, 1, 32, 4, 128, 40, 16),
    "deepseek-7b": (8, 1, 32, 32, 128, 40, 16),
    "arctic-480b": (8, 1, 56, 8, 128, 40, 16),
    "whisper-tiny": (8, 1, 6, 6, 64, 28, 16),
    "phi-3-vision-4.2b": (8, 1, 32, 32, 96, 76, 16),
    "nemotron-4-340b": (8, 1, 96, 8, 192, 40, 16),
    "verify": (8, 4, 16, 8, 128, 40, 16),
}
PAGE_SIZES = (1, 2, 4, 8, 16, 32)


class Work(NamedTuple):
    b: int
    kv_head: int
    chunk: int
    split: int
    rows: range          # the block's query rows r = i*G + g of the G*S
    stages: list         # per stage: the page (table column) of each slot,
                         # or None where the slot lands as zeros


def block_work(p, B, S, G, n_pages, P, pos):
    """The work of every bf16 block, as the kernel derives it: blockIdx
    (split, kv-head x chunk, table row), the chunk's rows [16*tiles*chunk,
    +16*tiles) of the G*S, the split's pages [span*split, end), the live
    ones up to the last position of the chunk's queries, `pages` slots a
    stage."""
    pos = np.asarray(pos).reshape(B, S)
    for b, y, split in itertools.product(range(B), range(p.blocks // (
            B * p.splits)), range(p.splits)):
        hk, chunk = divmod(y, p.chunks)
        row0 = 16 * p.tiles * chunk
        rows = range(row0, min(row0 + 16 * p.tiles, G * S))
        pg0 = split * p.span
        pg_end = min(pg0 + p.span, n_pages)
        pos_max = int(pos[b, rows[0] // G:rows[-1] // G + 1].max())
        if pg0 * P > pos_max:
            yield Work(b, hk, chunk, split, rows, [])
            continue
        live_end = min(pg_end, pos_max // P + 1)
        n_iter = -(-(live_end - pg0) // p.pages)
        stages = [[pg if (pg := pg0 + it * p.pages + j) < live_end else None
                   for j in range(p.pages)] for it in range(n_iter)]
        yield Work(b, hk, chunk, split, rows, stages)


def warp_rows(p):
    """Consumer warp w: tile w % tiles, its rows of the block, and its
    share of each stage's rows (group w // tiles)."""
    share = p.keys // p.groups
    for w in range(PA.CONSUMERS):
        tile, grp = w % p.tiles, w // p.tiles
        yield (range(16 * tile, min(16 * tile + 16, p.rows)),
               range(grp * share, (grp + 1) * share))


def _positions(B, S, n_pages, P, seed):
    """Each table row's last query at a random position of the table
    (one row at -1 where B > 2), its S queries at pos .. pos - S + 1."""
    r = np.random.RandomState(seed)
    last = r.randint(0, n_pages * P, size=B)
    if B > 2:
        last[1] = -1
    return np.stack([last - (S - 1 - i) for i in range(S)], 1)


# the main shapes at 1 and 4 rows a table row (nemotron's G 12 x 4 = 48
# rows a block; G 12 x S 6 and G 1 x S 100, past 64 rows, take two
# chunks of rows), and odd edges
COVER = [(B, S, Hq, Hk, dh, n, P)
         for (B, _, Hq, Hk, dh, n, _), S, P in itertools.product(
             MAIN.values(), (1, 4), (1, 4, 16, 32))] + [
    (1, 1, 2, 2, 64, 300, 16), (3, 4, 84, 7, 32, 24, 8),
    (2, 4, 48, 4, 96, 12, 4), (5, 2, 16, 2, 64, 64, 2),
    (8, 6, 96, 8, 192, 40, 16), (2, 100, 16, 16, 128, 20, 16),
    (3, 9, 56, 8, 128, 30, 8), (4, 6, 84, 7, 32, 10, 4)]


@pytest.mark.parametrize("B,S,Hq,Hk,dh,n_pages,P", COVER)
def test_every_live_page_read_once_and_every_row_covered(B, S, Hq, Hk, dh,
                                                         n_pages, P):
    p = PA.plan(B, S, Hq, Hk, dh, n_pages, P)
    G = Hq // Hk
    assert p.rows == min(G * S, PA.MAX_ROWS)
    assert p.chunks == -(-G * S // (16 * p.tiles))
    assert p.blocks == p.splits * Hk * p.chunks * B
    pos = _positions(B, S, n_pages, P, seed=B * 100 + n_pages)
    reads = np.zeros((B, Hk, p.chunks, n_pages), np.int64)
    covered = np.zeros((B, Hk, p.splits, G * S), np.int64)
    last = {}                    # (b, chunk): its queries' last position
    for w in block_work(p, B, S, G, n_pages, P, pos):
        assert 0 < len(w.rows) <= p.rows
        covered[w.b, w.kv_head, w.split, list(w.rows)] += 1
        last[w.b, w.chunk] = int(pos[w.b, w.rows[0] // G:
                                     w.rows[-1] // G + 1].max())
        assert len(w.stages) <= -(-p.span // p.pages)
        for slots in w.stages:
            assert len(slots) == p.pages
            for pg in slots:
                if pg is not None:
                    assert w.split * p.span <= pg < (w.split + 1) * p.span
                    reads[w.b, w.kv_head, w.chunk, pg] += 1
    assert (covered == 1).all()
    for (b, c), top in last.items():
        live = -1 if top < 0 else top // P
        assert (reads[b, :, c, :live + 1] == 1).all(), (b, c, live)
        assert (reads[b, :, c, live + 1:] == 0).all(), (b, c, live)


@pytest.mark.parametrize("B,S,Hq,Hk,dh,n_pages,P", COVER)
def test_consumer_warps_split_rows_and_keys_once(B, S, Hq, Hk, dh, n_pages,
                                                 P):
    """Each of a block's rows is in one tile, each tile's rows see every
    stage row through exactly one of its warps, and a warp's share is
    whole 16-row mma steps."""
    p = PA.plan(B, S, Hq, Hk, dh, n_pages, P)
    assert p.tiles in (1, 2, 4) and p.tiles * p.groups == PA.CONSUMERS
    assert 16 * p.tiles >= p.rows > 16 * p.tiles // 2 or p.tiles == 1
    seen = np.zeros((p.rows, p.keys), np.int64)
    for rows, keys in warp_rows(p):
        assert len(keys) % 16 == 0
        for r in rows:
            seen[r, list(keys)] += 1
    assert (seen == 1).all()
    # a stage is whole pages of a power-of-two slot, P rows of it real
    assert p.slot >= max(8, P) and p.slot & (p.slot - 1) == 0
    assert p.keys == p.pages * p.slot and p.keys >= PA.STAGE_KEYS


@pytest.mark.parametrize("dh", PA.HEAD_DIMS)
@pytest.mark.parametrize("G", PA.GROUPS)
@pytest.mark.parametrize("S", [1, 4, 6])
def test_layout_fits_the_card(dh, G, S):
    """For every page size in use: at most 227 KB of shared memory a
    block (the split's table entries in it), 160 threads, a 256-row TMA
    box, 1-4 stages and at most 64 packed rows (G*S past 64 in chunks
    of 64)."""
    for P in PAGE_SIZES:
        for B, n_pages in ((8, 40), (1, 300), (64, 40)):
            p = PA.plan(B, S, 2 * G, 2, dh, n_pages, P)
            assert p.smem <= PA.SMEM_LIMIT
            assert p.smem == PA.smem_bytes(dh, p.stages, p.keys, p.tiles,
                                           p.span)
            assert PA.THREADS <= 1024
            assert p.slot <= PA.MAX_SLOT
            assert 1 <= p.stages <= PA.MAX_STAGES
            assert p.rows <= PA.MAX_ROWS
            assert p.chunks * 16 * p.tiles >= G * S
            assert 1 <= p.span <= n_pages
            assert p.splits * p.span >= n_pages > (p.splits - 1) * p.span


@pytest.mark.parametrize("name", sorted(MAIN))
def test_main_shapes_reach_a_full_wave(name):
    """The serve paths' decode shapes and the verify shape give at least
    one block an SM, or the plan states why not: where the (table row,
    kv-head) pairs fill the SMs no table row is split; else two blocks an
    SM at most FEW_ROWS rows a block, one above (whole splits may leave a
    few SMs idle, named in `why`).  Two or more stages are in flight where
    a split walks two or more, and the resident blocks fit an SM."""
    B, S, Hq, Hk, dh, n_pages, P = MAIN[name]
    p = PA.plan(B, S, Hq, Hk, dh, n_pages, P)
    pairs = B * Hk
    if pairs >= PA.SMS:
        assert p.splits == 1 and p.blocks == pairs and p.why == ""
    elif p.rows <= PA.FEW_ROWS:
        assert p.blocks >= 2 * PA.SMS and p.why == ""
    else:
        assert p.blocks > PA.SMS // 2
        assert p.blocks >= PA.SMS or "one block an SM" in p.why
    walk = -(-p.span // p.pages)
    assert p.stages >= min(2, walk)
    assert PA.RESIDENT[dh] * (p.smem + 1024) <= PA.SMEM_SM


def test_verify_plans_table_rows_not_query_rows():
    """The verify form plans B table rows (their pages read once for all
    S candidates: blocks of (split, kv-head, table row)), where the fp32
    kernel plans a block per query row."""
    B, S, Hq, Hk, dh, n_pages, P = MAIN["verify"]
    four = PA.plan(B, S, Hq, Hk, dh, n_pages, P)
    assert four.rows == S * Hq // Hk
    assert four.blocks == four.splits * Hk * B
    f32 = PA.plan(B, S, Hq, Hk, dh, n_pages, P, torch.float32)
    assert f32.blocks == f32.splits * Hk * B * S
    assert PA.workspace_numel(four, B, S, Hq, dh) == \
        B * S * Hq * four.splits * (dh + 2)


def test_short_tables_state_why_the_grid_is_small():
    p = PA.plan(1, 1, 4, 4, 64, 4, 16)
    assert p.splits == 1 and p.blocks < PA.SMS
    assert "64 positions" in p.why
    p = PA.plan(8, 1, 32, 4, 128, 40, 16)           # qwen3-moe: 8 rows
    assert p.blocks < PA.SMS and "one block an SM" in p.why


def test_the_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="past the bf16 kernel"):
        PA.plan(8, 1, 16, 8, 128, 4, 512)          # a 512-row page
    # the fp32 kernel takes it
    assert PA.plan(8, 1, 16, 8, 128, 4, 512, torch.float32).span == 1


@pytest.mark.parametrize("P,sub", [(300, 150), (512, 256), (257, 1),
                                   (768, 256)])
def test_pages_past_a_box_read_as_sub_pages_attend_the_same(P, sub):
    """The bf16 wrapper reads a page of more than 256 positions as
    sub-pages (`box_pages`): through the plain version the remapped pools
    and table give bit for bit the output of the pages, a stale table
    entry naming another row's page included."""
    r = np.random.RandomState(P)
    B, S, Hq, Hk, dh, n_max = 3, 2, 8, 4, 32, 3
    Np = B * n_max + 1
    q = torch.from_numpy(r.randn(B, S, Hq, dh).astype(np.float32))
    kp, vp = (torch.from_numpy(r.randn(Np, P, Hk, dh).astype(np.float32))
              for _ in range(2))
    bt = torch.from_numpy(r.permutation(Np)[:B * n_max].reshape(B, n_max)
                          .astype(np.int32))
    bt[0, 2] = bt[1, 0]                # row 0 never reaches it
    pos = torch.tensor([[P - 2, P + 3], [0, 3 * P - 1], [-1, 2 * P]],
                       dtype=torch.int32)
    kb, vb, bb = PA.box_pages(kp, vp, bt)
    assert kb.shape[1] == sub and bb.shape == (B, n_max * P // sub)
    assert PA.plan(B, S, Hq, Hk, dh, bb.shape[1], sub).slot <= PA.MAX_SLOT
    assert torch.equal(PA.reference(q, kb, vb, bb, pos),
                       PA.reference(q, kp, vp, bt, pos))


@pytest.mark.parametrize("k", [3, 5, 8, 9, 31, 32, 63])
def test_verify_rounds_of_any_k_plan_for_every_group(k):
    """`serve --spec-k k` verifies k + 1 rows a table row: every group
    plans, its G*(k+1) rows in blocks of at most 64 (nemotron's G 12
    past k 4, qwen3-moe's G 8 past k 7, arctic's G 7 past k 8, qwen3's
    G 2 past k 31), the chunks' rows covering the group once."""
    for G in PA.GROUPS:
        for dh in PA.HEAD_DIMS:
            p = PA.plan(8, k + 1, 8 * G, 8, dh, 40, 16)
            M = G * (k + 1)
            assert p.rows == min(M, PA.MAX_ROWS)
            assert (p.chunks - 1) * 16 * p.tiles < M <= \
                p.chunks * 16 * p.tiles
            assert p.blocks == p.splits * 8 * p.chunks * 8
            assert p.smem <= PA.SMEM_LIMIT
