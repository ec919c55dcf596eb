"""The flash kernel's plan (`kernels/flash_attention.plan`), on the CPU.

The plan is host arithmetic on the shapes; `block_work` below spells out
the work each block of the grid derives from it, as the kernel
(csrc/flash_attention.cu) does from blockIdx.  These tests hold the plan
to what the kernel needs:
every (batch row, query position, q-head) in exactly one query tile, each
row's visible keys walked exactly once across the tile's key splits, and
a layout that fits the card (shared memory, threads, tensor-map boxes,
grid) for every head dim and group the models use.  The kernel itself is
held against its plain version in tests/test_torch_cuda.py, on the card.
"""
import itertools
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro_torch.kernels import flash_attention as FA  # noqa: E402

GROUPS = (1, 2, 4, 7, 8, 12)
# the timed shapes of chip_smoke.py phase 5 (B, S, T, Hq, Hk, dh, causal):
# the serve paths' prefills, whisper's encoder and cross-attention, and
# qwen3-0.6b's longer prefills
MAIN = {
    "qwen3-0.6b": (1, 512, 512, 16, 8, 128, True),
    "zamba2-1.2b": (1, 512, 512, 32, 32, 64, True),
    "qwen3-moe-30b-a3b": (1, 512, 512, 32, 4, 128, True),
    "deepseek-7b": (1, 512, 512, 32, 32, 128, True),
    "arctic-480b": (1, 512, 512, 56, 8, 128, True),
    "whisper-tiny": (1, 1500, 1500, 6, 6, 64, False),
    "whisper-tiny:cross": (1, 192, 1500, 6, 6, 64, False),
    "phi-3-vision-4.2b": (1, 1088, 1088, 32, 32, 96, True),
    "nemotron-4-340b": (1, 512, 512, 96, 8, 192, True),
    "qwen3-0.6b S=1024": (1, 1024, 1024, 16, 8, 128, True),
    "qwen3-0.6b S=8192": (1, 8192, 8192, 16, 8, 128, True),
}
# coverage cases (B, S, T, Hq, Hk, dh, causal, window): ragged S and T,
# G 7 and 12 leaving rows empty, windows, S < T, S > T (rows that see no
# key), T >> S (key splits), one query row
COVER = [
    (1, 200, 200, 16, 8, 128, True, None),
    (2, 129, 129, 8, 2, 32, True, 40),
    (1, 100, 100, 14, 2, 128, True, None),
    (1, 77, 77, 24, 2, 64, True, None),
    (2, 53, 53, 24, 2, 192, True, None),
    (1, 300, 300, 16, 2, 128, True, 50),
    (1, 700, 700, 14, 2, 192, True, 130),
    (1, 40, 2000, 12, 1, 64, True, None),
    (1, 33, 3000, 12, 1, 192, True, None),
    (1, 64, 4096, 8, 8, 128, False, None),
    (1, 100, 2000, 8, 4, 96, True, 700),
    (1, 300, 100, 14, 2, 128, True, None),
    (2, 150, 64, 8, 8, 64, True, None),
    (1, 1, 64, 4, 4, 64, True, None),
    (2, 33, 64, 4, 1, 64, False, None),
    (1, 192, 1500, 6, 6, 64, False, None),
    (1, 512, 512, 96, 8, 192, True, None),
    (1, 6144, 6144, 16, 8, 128, True, 4096),
]


class Work(NamedTuple):
    b: int
    heads: range       # q-heads
    kv_head: int
    positions: range   # query positions
    keys: range        # the keys of the split's tiles (may pass T)


def block_work(p, B, S, T, Hq, Hk, causal, window):
    """The work of every block, as the kernel derives it from blockIdx
    (x: split fastest, then head group, then batch row; y: query tiles,
    heaviest first)."""
    groups = Hq // p.pack
    for by in range(p.q_tiles):
        s0 = (p.q_tiles - 1 - by) * p.positions
        s_end = min(s0 + p.positions, S)
        lo, n_all = FA.key_tiles(S, T, s0, s_end, causal, window)
        for bx in range(p.splits * groups * B):
            sp, rest = bx % p.splits, bx // p.splits
            hq0, b = (rest % groups) * p.pack, rest // groups
            first = sp * n_all // p.splits
            n = (sp + 1) * n_all // p.splits - first
            k0 = lo + first * FA.KEYS
            yield Work(b, range(hq0, hq0 + p.pack), hq0 // (Hq // Hk),
                       range(s0, s_end), range(k0, k0 + n * FA.KEYS))


def _visible(S, T, s, causal, window):
    """[lo, hi): the keys query position s sees (queries end at T-1)."""
    if not causal:
        return 0, T
    q = s + T - S
    lo = 0 if window is None else max(0, q - window + 1)
    return lo, max(lo, min(T, q + 1))


def _tiles(p, B, S, T, Hq, Hk, causal, window):
    """{(b, first head, first position): [(split, keys range, work)]}"""
    tiles = {}
    for w in block_work(p, B, S, T, Hq, Hk, causal, window):
        key = (w.b, w.heads.start, w.positions.start)
        tiles.setdefault(key, []).append(w)
    return tiles


@pytest.mark.parametrize("B,S,T,Hq,Hk,dh,causal,window", COVER)
def test_plan_covers_every_row_and_visible_key_once(B, S, T, Hq, Hk, dh,
                                                   causal, window):
    p = FA.plan(B, S, T, Hq, Hk, dh, causal, window)
    G = Hq // Hk
    tiles = _tiles(p, B, S, T, Hq, Hk, causal, window)
    assert len(tiles) * p.splits == p.blocks
    seen = torch.zeros(B, S, Hq, dtype=torch.int32)
    for (b, h0, s0), works in tiles.items():
        assert len(works) == p.splits
        w0 = works[0]
        assert all(w.heads == w0.heads and w.positions == w0.positions
                   and w.kv_head == w0.kv_head for w in works)
        # one KV group: every q-head of the block reads kv-head h // G
        assert {h // G for h in w0.heads} == {w0.kv_head}
        assert len(w0.positions) <= p.positions
        seen[b, w0.positions.start:w0.positions.stop,
             w0.heads.start:w0.heads.stop] += 1
        # the splits walk disjoint runs of whole key tiles, in order
        runs = [w.keys for w in works if len(w.keys)]
        for r in runs:
            assert r.start % FA.KEYS == 0 and len(r) % FA.KEYS == 0
        for a, c in zip(runs, runs[1:]):
            assert a.stop == c.start
        lo = runs[0].start if runs else 0
        hi = runs[-1].stop if runs else 0
        for s in w0.positions:
            vlo, vhi = _visible(S, T, s, causal, window)
            if vhi > vlo:          # every visible key of the row, once
                assert lo <= vlo and vhi <= hi, (s, vlo, vhi, lo, hi)
        # no run lies wholly outside what the tile's rows see
        tile_lo = min(_visible(S, T, s, causal, window)[0]
                      for s in w0.positions)
        tile_hi = max(_visible(S, T, s, causal, window)[1]
                      for s in w0.positions)
        for r in runs:
            assert r.start < tile_hi and r.stop > tile_lo - FA.KEYS
    assert bool((seen == 1).all())


@pytest.mark.parametrize("dh,G", itertools.product(FA.HEAD_DIMS, GROUPS))
def test_plan_fits_the_card(dh, G):
    """Shared memory, threads, registers' layout, TMA boxes and the grid,
    at short and long prompts, one and several KV heads."""
    for S, Hk, causal, window in ((1, 1, True, None), (129, 2, True, None),
                                  (512, 8, True, None),
                                  (1500, 1, False, None),
                                  (8192, 8, True, 4096)):
        p = FA.plan(1, S, S, G * Hk, Hk, dh, causal, window)
        assert p.rows in FA.ROW_CHOICES and p.keys == FA.KEYS
        assert p.rows == 128 or dh <= FA.MAX_DH_64_ROWS
        assert G % p.pack == 0 and p.positions == p.rows // p.pack >= 1
        assert 2 <= p.stages <= FA.MAX_STAGES
        assert p.smem == FA.smem_bytes(p.rows, dh, p.stages)
        assert p.smem <= FA.SMEM_LIMIT
        if p.rows == 64 and p.stages > 2:   # two blocks an SM
            assert 2 * (p.smem + 1024) <= FA.SMEM_SM
        assert 128 * (p.rows // 64 + 1) <= 1024          # threads
        assert p.pack <= 256 and p.positions <= 256      # TMA box dims
        assert p.q_tiles == -(-S // p.positions) <= 65535
        assert p.splits >= 1
        assert p.blocks == p.q_tiles * p.splits * (G * Hk // p.pack)


def test_plan_packs_whole_groups():
    """G 7 and 12 do not divide 64 or 128: the rows past whole groups of
    positions stay empty rather than split a group over blocks."""
    for G, rows_used in ((7, {63, 126}), (12, {60, 120})):
        for dh in FA.HEAD_DIMS:
            p = FA.plan(1, 512, 512, G, 1, dh)
            assert p.pack == G and p.pack * p.positions in rows_used


@pytest.mark.parametrize("name", sorted(MAIN))
def test_plan_fills_the_card_at_the_main_shapes(name):
    """At least one block for each of the H100's 132 SMs at every timed
    shape; a plan that cannot says why."""
    B, S, T, Hq, Hk, dh, causal = MAIN[name]
    p = FA.plan(B, S, T, Hq, Hk, dh, causal)
    assert p.blocks >= FA.SMS, p
    assert p.why == ""


def test_plan_says_why_a_small_grid_stays_small():
    """One request's 4 heads of a 1-token prompt fill 4 blocks, and a key
    split would walk less than a tile: the plan keeps 4 and says so."""
    p = FA.plan(1, 1, 64, 4, 4, 64)
    assert (p.blocks, p.splits) == (4, 1)
    assert "4 blocks" in p.why


def test_plan_splits_keys_only_where_the_grid_is_short():
    """whisper-tiny's cross-attention (18 query tiles, 24 key tiles each)
    splits its keys; the serve prefills that fill the card do not."""
    cross = FA.plan(*MAIN["whisper-tiny:cross"])
    assert cross.splits > 1 and cross.blocks >= FA.SMS
    for name in ("nemotron-4-340b", "arctic-480b", "phi-3-vision-4.2b",
                 "qwen3-0.6b S=8192"):
        assert FA.plan(*MAIN[name]).splits == 1
    assert FA.workspace_numel(cross, 1, 192, 6, 64) == (
        cross.splits * 192 * 6 * 66)
