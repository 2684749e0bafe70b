"""The host side of the bf16 ``grouped_gemm`` kernel, on the CPU.

The kernel (``src/repro_torch/csrc/grouped_gemm.cu``) runs only on the card,
so everything around it that the CPU can reach lives in the wrapper and is
held here: the schedule chosen from the static shape (A, H, F), the work
of the persistent grid's lanes (every output tile and every 64-deep k block
covered exactly once, a split tile's pieces in k order), and the TMA maps'
dims, strides and boxes against the encoder's limits. A numpy emulation of
the plan, block by block as the lanes walk it (segments summed from zero,
a partial handed on where a share ends inside a segment, segments folded
in k order, rows past the count zeroed), is held against the JAX package's
``grouped_gemm`` within 1e-5 in f32, at counts on every tile edge, and
bitwise against itself at other slot counts.
"""
import ctypes
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import grouped_gemm as gg

# DBRX-132B's four path shapes per hosted rank (2 local experts, d_model
# 6144, d_ff_expert 10752; A = 128 at decode, 10240 at HT prefill) and the
# card tests' shapes (H and F multiples of 8 but not of 64)
DBRX = {"decode gate": (2, 128, 6144, 10752), "decode down": (2, 128, 10752, 6144),
        "HT gate": (2, 10240, 6144, 10752), "HT down": (2, 10240, 10752, 6144)}
SMALL = {f"L{L}-A{A}": (L, A, 264, 200) for A in (128, 136, 1000) for L in (1, 3)}
SHAPES = {**DBRX, **SMALL}


def tma_limits_hold(m: tuple) -> bool:
    """What cuTensorMapEncodeTiled takes for a 3-D bf16 map with the
    128-byte swizzle: dims in [1, 2^32], strides multiples of 16 below
    2^40, a box edge in [1, 256] whose inner extent is at most 128 bytes.
    m is a plan's (dim0, dim1, dim2, stride1, stride2, box0, box1)."""
    d0, d1, d2, s1, s2, b0, b1 = m
    return (all(1 <= d <= 2 ** 32 for d in (d0, d1, d2))
            and all(s % 16 == 0 and 0 < s < 2 ** 40 for s in (s1, s2))
            and 1 <= b1 <= 256 and 1 <= b0 and b0 * 2 <= 128)


def edges(A):
    """Counts on every tile edge, at A and one past it."""
    return [0, 1, 63, 64, 65, 127, 128, A, A + 1]


def pieces_by_tile(p):
    """tile -> its pieces (piece, pieces, kb0, kb1), over every lane."""
    seen = {}
    for lane in range(p.grid):
        for t, kb0, kb1, j, n in gg.lane_work(p, lane):
            seen.setdefault(t, []).append((j, n, kb0, kb1))
    return seen


@pytest.mark.parametrize("name", SHAPES)
def test_work_covers_every_tile_and_k_block_once(name):
    L, A, H, F = SHAPES[name]
    p = gg.plan(L, A, H, F)
    assert (p.m_tiles - 1) * gg.BM < A <= p.m_tiles * gg.BM
    assert (p.n_tiles - 1) * p.bn < F <= p.n_tiles * p.bn
    assert (p.kb_total - 1) * gg.BK < H <= p.kb_total * gg.BK
    assert p.tiles == L * p.m_tiles * p.n_tiles and 1 <= p.grid <= gg.SMS
    coords = {gg.tile_coords(p, t) for t in range(p.tiles)}
    assert coords == {(l, mt, nt) for l in range(L) for mt in range(p.m_tiles)
                      for nt in range(p.n_tiles)}
    seen = pieces_by_tile(p)
    assert sorted(seen) == list(range(p.tiles))
    for t, pieces in seen.items():
        pieces.sort()
        n = len(pieces)
        assert [j for j, *_ in pieces] == list(range(n))
        assert all(m == n for _, m, _, _ in pieces)
        assert n == 1 or t < p.sk_tiles
        assert n <= max(p.max_pieces, 1)
        # the pieces are consecutive k ranges, in piece order, covering K
        assert [k for *_, kb0, kb1 in pieces for k in range(kb0, kb1)] == \
            list(range(p.kb_total))


@pytest.mark.parametrize("name", SHAPES)
def test_a_split_tile_waits_only_on_later_lanes(name):
    """A split tile's first piece is the last piece of its lane and waits
    for the others; they are each the first piece of a later lane, so no
    lane waits on an earlier one and no wait can close a cycle."""
    p = gg.plan(*SHAPES[name])
    where = {}
    for lane in range(p.grid):
        work = gg.lane_work(p, lane)
        for i, (t, _, _, j, n) in enumerate(work):
            if n > 1:
                where[(t, j)] = (lane, i, len([w for w in work if w[4] > 1]))
    for (t, j), (lane, i, n_split) in where.items():
        if j == 0:
            assert i == n_split - 1       # its lane's last split piece
            assert all(where[(t, k)][0] > lane for k in range(1, len(
                [key for key in where if key[0] == t])))
        else:
            assert i == 0                 # the first piece of its lane


@pytest.mark.parametrize("name", SHAPES)
def test_schedule_follows_the_static_shape(name):
    L, A, H, F = SHAPES[name]
    p = gg.plan(L, A, H, F)
    if A <= gg.STREAM_MAX_A:
        # one tile holds every row: each weight byte is read once per call
        assert (p.schedule, p.bn, p.m_tiles) == ("stream", 128, 1)
    else:
        assert (p.schedule, p.bn, p.sk_tiles, p.group_m) == ("compute", 256, 0, 8)
    assert p.scratch_floats() == ((p.sk_tiles * p.slots + p.grid) * gg.BM * p.bn
                                  if p.sk_tiles else 0)


@pytest.mark.parametrize("name", ["decode gate", "decode down"])
def test_decode_lanes_stream_equal_shares(name):
    """The down projection has 48 column tiles x 2 experts: 96 tiles on 132
    SMs. Stream-K gives every lane the same k blocks, one more at most."""
    p = gg.plan(*DBRX[name])
    loads = [sum(kb1 - kb0 for _, kb0, kb1, _, _ in gg.lane_work(p, lane))
             for lane in range(p.grid)]
    assert p.grid == gg.SMS and p.sk_tiles > 0
    assert max(loads) == -(-p.tiles * p.kb_total // gg.SMS)
    assert sum(loads) == p.tiles * p.kb_total
    # at most one whole tile and the pieces of two split tiles a lane
    assert max(len(gg.lane_work(p, lane)) for lane in range(p.grid)) <= 3


def test_compute_walks_bands_of_row_tiles():
    """The first wave of the HT gate, one tile per lane, lies in one band of
    eight row tiles of one expert, so concurrent tiles share their strips of
    x and w in L2."""
    p = gg.plan(*DBRX["HT gate"])
    first = {gg.tile_coords(p, t)[:2] for t in range(p.grid)}
    assert {l for l, _ in first} == {0} and {mt for _, mt in first} == set(range(8))


@pytest.mark.parametrize("name", SHAPES)
def test_tma_maps_hold_the_encoder_limits(name):
    L, A, H, F = SHAPES[name]
    p = gg.plan(L, A, H, F)
    assert p.x_map == (H, A, L, 2 * H, 2 * A * H, 64, 64)
    assert p.w_map == (F, H, L, 2 * F, 2 * H * F, 64, 64)
    assert tma_limits_hold(p.x_map) and tma_limits_hold(p.w_map)
    # models/moe.py hands the kernel w_gate[r*L:(r+1)*L]: a contiguous slice
    # whose start moves by whole experts, 16-byte aligned
    assert (L * H * F * 2) % 16 == 0


def test_tma_limits_refuse_what_the_encoder_refuses():
    assert not tma_limits_hold((4, 8, 1, 8, 64, 64, 64))        # stride of 8 bytes
    assert not tma_limits_hold((256, 8, 1, 512, 4096, 128, 64))  # 256-byte inner box
    assert not tma_limits_hold((256, 8, 1, 512, 4096, 64, 512))  # box edge > 256
    assert not tma_limits_hold((0, 8, 1, 16, 64, 64, 64))        # empty dim


def test_the_wrapper_plans_without_reading_counts(monkeypatch):
    """The plan is a function of (L, A, H, F) alone; the wrapper passes the
    same plan whatever the counts, and launches once per call."""
    assert list(inspect.signature(gg.plan).parameters) == ["L", "A", "H", "F"]
    calls = []

    def fake_launch(name, x, w, c, o, L, A, H, F, dt, plan, scratch, sems):
        n = len(gg.plan(L, A, H, F).args())
        calls.append((list((ctypes.c_int64 * n).from_address(plan)),
                      scratch is not None, sems is not None))

    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "launch", fake_launch)
    L, A, H, F = SMALL["L3-A128"]
    x = torch.zeros((L, A, H), dtype=torch.bfloat16)
    w = torch.zeros((L, H, F), dtype=torch.bfloat16)
    before = gg.launches
    for c in ([0, 0, 0], [1, 64, 200], [500, 128, 65]):
        gg.grouped_gemm(x, w, torch.tensor(c, dtype=torch.int32))
    assert gg.launches == before + 3
    want = gg.plan(L, A, H, F)
    assert want.sk_tiles > 0
    assert calls == [(want.args(), True, True)] * 3


def emulate(p, x, w, counts):
    """The kernel's arithmetic in f32, as the lanes walk ``lane_runs``, one
    64-deep k block at a time: a segment's blocks accumulated from zero, or
    from the partial the lane before handed on where its share ended inside
    the segment; a whole tile or a first piece folding its segments in k
    order, the others writing theirs to scratch slots that the first piece
    folds after its own (under compute, K is one segment); rows at or past
    the count zero. Every slot and every handed-on partial is used once."""
    L, A, H = x.shape
    F = w.shape[2]
    K = p.kb_total
    seg = p.seg or K
    out = np.full((L, A, F), np.nan, np.float32)
    handed, slots, firsts = {}, {}, []
    for lane in range(p.grid):
        for kind, t, kb0, kb1, j, n in gg.lane_runs(p, lane):
            l, mt, nt = gg.tile_coords(p, t)
            cnt, r0, n0 = min(int(counts[l]), A), mt * gg.BM, nt * p.bn
            rows, cols = slice(r0, min(r0 + gg.BM, A)), slice(n0, min(n0 + p.bn, F))
            if r0 >= cnt:
                if kind == "piece" and j == 0:
                    out[l, rows, cols] = 0.0
                continue
            zero = np.zeros((rows.stop - r0, cols.stop - n0), np.float32)

            def blocks(k0, k1, reg, at_end):
                for kb in range(k0, k1):
                    if kb % seg == 0:
                        reg = zero
                    k = slice(kb * gg.BK, min((kb + 1) * gg.BK, H))
                    reg = reg + x[l, rows, k] @ w[l, k, cols]
                    if (kb + 1) % seg == 0:
                        at_end(kb // seg, reg)
                return reg

            if kind == "handoff":
                handed[lane] = blocks(kb0, kb1, handed.pop(lane - 1) if kb0 % seg else zero,
                                      None)
            elif j == 0:
                acc = [zero]
                blocks(kb0, kb1, zero, lambda i, r: acc.__setitem__(0, acc[0] + r))
                firsts.append((l, rows, cols, cnt, t, acc[0], kb1 // seg, n))
            elif kb1 > kb0:
                c = -(-kb0 // seg) * seg
                store = lambda i, r: slots.__setitem__((t, i), r)  # noqa: E731
                blocks(c, kb1, zero, store)
                if kb0 < c:
                    blocks(kb0, c, handed.pop(lane - 1), store)
    for l, rows, cols, cnt, t, acc, first, n in firsts:
        if n > 1:
            for i in range(first, K // seg):
                acc = acc + slots.pop((t, i))
        acc = acc.copy()
        acc[max(0, cnt - rows.start):] = 0.0
        out[l, rows, cols] = acc
    assert not handed and not slots
    return out


@pytest.mark.parametrize("name", SMALL)
def test_plan_emulation_matches_the_jax_package(name, monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "off")
    L, A, H, F = SMALL[name]
    rng = np.random.default_rng(15)
    x = (rng.standard_normal((L, A, H)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((L, H, F)) * 0.1).astype(np.float32)
    p = gg.plan(L, A, H, F)
    for i in range(len(edges(A))):
        counts = np.array([edges(A)[(i + l) % len(edges(A))] for l in range(L)], np.int32)
        got = emulate(p, x, w, counts)
        want = np.asarray(jops.grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(counts)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for l in range(L):
            assert not got[l, min(int(counts[l]), A):].any()


@pytest.mark.parametrize("K", [1, 5, 32, 48, 96, 112, 168, 97])
def test_the_segment_is_the_largest_divisor_of_k_up_to_seg_max(K):
    seg = gg.segment(K)
    assert K % seg == 0 and 1 <= seg <= gg.SEG_MAX
    assert not any(K % d == 0 for d in range(seg + 1, min(K, gg.SEG_MAX) + 1))


def runs_by_tile(p):
    """tile -> its runs (kind, kb0, kb1, piece, lane), over every lane."""
    seen = {}
    for lane in range(p.grid):
        for kind, t, kb0, kb1, j, n in gg.lane_runs(p, lane):
            seen.setdefault(t, []).append((kind, kb0, kb1, j, lane))
    return seen


# stream shapes with split tiles at several slot counts: a segment of 1,
# several segments a tile, one segment a tile (shares inside a segment)
WALKS = {f"L{L}-H{H}-F{F}": (L, 128, H, F)
         for L, H, F in [(1, 264, 200), (3, 264, 200), (2, 6144, 8960), (3, 6144, 8960),
                         (5, 2048, 7168), (2, 1024, 8960), (1, 64 * 13, 128 * 131)]}


@pytest.mark.parametrize("name", WALKS)
def test_runs_cover_every_k_block_once_and_hand_on_inside_a_segment(name):
    """The runs of all lanes cover every k block of every tile once; a lane
    hands a partial on exactly where its share ends inside a segment, and
    a run goes on from a partial exactly where it starts inside one."""
    p = gg.plan(*WALKS[name])
    assert p.schedule == "stream" and p.sk_tiles > 0
    for t, runs in runs_by_tile(p).items():
        blocks = sorted(k for _, kb0, kb1, _, _ in runs for k in range(kb0, kb1))
        assert blocks == list(range(p.kb_total))
    for lane in range(p.grid):
        runs = gg.lane_runs(p, lane)
        h = gg.handoff(p, lane)
        assert (runs[0][0] == "handoff") == (h is not None)
        assert [r[0] for r in runs[1:]] == ["piece"] * (len(runs) - 1)
        if h is not None:
            t, h0, h1 = h
            assert h1 % p.seg and h0 < h1 and (h0 % p.seg == 0 or h0 == runs[1][2])
        for kind, t, kb0, kb1, j, n in runs[1:]:
            # a piece ends on a segment edge, or is empty
            assert kb1 == kb0 or kb1 % p.seg == 0


def simulate_waits(p):
    """Runs the lanes' waits and signals one step at a time, round robin, as
    the kernel orders them: a hand-on run that starts inside a segment waits
    for the lane before's partial, then signals its own; a later piece that
    starts inside a segment waits for it after its whole segments, then
    counts itself in; a split tile's first piece waits for the others'
    counts. Returns the flags and counters left at the end (None when no
    lane can move: a deadlock)."""
    steps = []
    for lane in range(p.grid):
        s = []
        for kind, t, kb0, kb1, j, n in gg.lane_runs(p, lane):
            if kind == "handoff":
                if kb0 % p.seg:
                    s.append(("take", lane - 1))
                s.append(("give", lane))
            elif j > 0:
                if kb1 > kb0 and kb0 % p.seg:
                    s.append(("take", lane - 1))
                s.append(("count", t))
            elif n > 1:
                s.append(("await", t, n - 1))
        steps.append(s)
    flags, counts, pos = {}, {}, [0] * p.grid
    while any(pos[i] < len(steps[i]) for i in range(p.grid)):
        moved = False
        for i in range(p.grid):
            if pos[i] == len(steps[i]):
                continue
            op = steps[i][pos[i]]
            if op[0] == "take":
                if not flags.get(op[1]):
                    continue
                flags[op[1]] = 0
            elif op[0] == "give":
                assert not flags.get(op[1])
                flags[op[1]] = 1
            elif op[0] == "count":
                counts[op[1]] = counts.get(op[1], 0) + 1
            else:
                if counts.get(op[1], 0) < op[2]:
                    continue
                counts[op[1]] = 0
            pos[i] += 1
            moved = True
        if not moved:
            return None
    return flags, counts


@pytest.mark.parametrize("name", {**WALKS, **{k: v for k, v in SHAPES.items() if v[1] <= 128}})
def test_the_waits_cannot_deadlock_and_leave_every_counter_zero(name):
    """Every wait is met (a lane waits only on the first run of the lane
    before it, or on the later lanes' first pieces), every handed-on
    partial is taken once, and every counter is back at 0, as the next call
    on the stream needs."""
    p = gg.plan(*{**WALKS, **SHAPES}[name])
    left = simulate_waits(p)
    assert left is not None
    flags, counts = left
    assert not any(flags.values()) and not any(counts.values())


def chain(x, w, counts, seg):
    """Each tile of 128 rows x 128 columns as one lane computes it whole:
    its segments accumulated block by block from zero, folded in k order."""
    L, A, H = x.shape
    F = w.shape[2]
    K = -(-H // gg.BK)
    out = np.zeros((L, A, F), np.float32)
    for l in range(L):
        for n0 in range(0, F, 128):
            acc = np.zeros((A, min(128, F - n0)), np.float32)
            for s0 in range(0, K, seg):
                reg = np.zeros_like(acc)
                for kb in range(s0, s0 + seg):
                    k = slice(kb * gg.BK, min((kb + 1) * gg.BK, H))
                    reg = reg + x[l, :, k] @ w[l, k, n0:n0 + 128]
                acc = acc + reg
            acc[min(int(counts[l]), A):] = 0.0
            out[l, :, n0:n0 + 128] = acc
    return out


@pytest.mark.parametrize("name", WALKS)
def test_a_rows_bits_do_not_depend_on_the_slot_count(name):
    """EPLB changes the slots a rank holds, so L, so which tiles are split
    and where. The emulated arithmetic of the plan equals, bitwise, that of
    every tile computed whole in one lane, at this L and with the slots in
    reverse order, in f32."""
    L, A, H, F = WALKS[name]
    rng = np.random.default_rng(22)
    x = (rng.standard_normal((L, A, H)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((L, H, F)) * 0.1).astype(np.float32)
    counts = np.array([128, 40, 96, 7, 65][:L], np.int32)
    p = gg.plan(L, A, H, F)
    want = chain(x, w, counts, p.seg)
    np.testing.assert_array_equal(emulate(p, x, w, counts), want)
    rev = emulate(p, x[::-1].copy(), w[::-1].copy(), counts[::-1].copy())
    np.testing.assert_array_equal(rev[::-1], want)


@pytest.mark.parametrize("seg_max", [1, 4, 7])
def test_short_segments_keep_the_shares_and_the_bits(seg_max, monkeypatch):
    """With shorter segments (SEG_MAX 1, 4, 7) the shares are the same and
    the emulated rows are still those of every tile computed whole."""
    L, A, H, F = WALKS["L2-H6144-F8960"]
    before = gg.plan(L, A, H, F)
    monkeypatch.setattr(gg, "SEG_MAX", seg_max)
    gg.plan.cache_clear()
    try:
        p = gg.plan(L, A, H, F)
        assert p.seg == gg.segment(p.kb_total) <= seg_max
        assert (p.sk_tiles, p.sk_per, p.grid) == (before.sk_tiles, before.sk_per, before.grid)
        rng = np.random.default_rng(5)
        x = (rng.standard_normal((L, A, H)) * 0.1).astype(np.float32)
        w = (rng.standard_normal((L, H, F)) * 0.1).astype(np.float32)
        counts = np.array([100, 33], np.int32)
        np.testing.assert_array_equal(emulate(p, x, w, counts), chain(x, w, counts, p.seg))
        assert simulate_waits(p) is not None
    finally:
        gg.plan.cache_clear()
