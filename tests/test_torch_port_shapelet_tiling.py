"""How the shapelet-distance kernels K1-K4 cut their work, emulated in
numpy, so that a tiling error shows on the CPU.

`csrc/shapelet_common.cuh` picks each bank's tiling on the host
(`fwd_tiling`, `bwd_tiling`) and maps a block to its windows, taps, rows
and batch rows (`l1_fwd_block`, `l1_bwd_block`); K3 and K4 take the same
tiling per bank from a table (`shapelet_l1_grouped_*.cu`). This file takes
the constants from that header, repeats the host's choice and the block
mapping, and checks that every (window, tap, shapelet row, batch row) is
computed and stored exactly once, that every staged read lies inside what
the block staged, and that at the flagship's six banks a block issues at
most 5 % taps beyond the work. No CUDA is needed.
"""

import os
import re

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "sie_tpu_torch", "csrc", "shapelet_common.cuh")
with open(HEADER) as fh:
    SRC = fh.read()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, f"{name} not found in shapelet_common.cuh"
    return int(m.group(1))


FWD_THREADS = _const("FWD_THREADS")
NS_MAX = _const("NS_MAX")
WPT = _const("WPT")
LC = _const("LC")
WT_MAX = _const("WT_MAX")
TPT = _const("TPT")
NSB_MAX = _const("NSB_MAX")
BWD_THREADS_MAX = _const("BWD_THREADS_MAX")
QMAX = _const("QMAX")
BWD_TILES_MAX = _const("BWD_TILES_MAX")

FLAGSHIP = dict(B=64, T=845, n=10)
FLAGSHIP_LENGTHS = (43, 85, 169, 254, 423, 676)


def cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------- host choices
def fwd_rows(n):
    return cdiv(n, cdiv(n, NS_MAX))


def bwd_rows(n):
    return cdiv(n, cdiv(n, NSB_MAX))


def fwd_tiling(b, w):
    tiles = cdiv(w, WT_MAX)
    wt = cdiv(w, tiles)
    tpr = cdiv(wt, WPT)
    segs = b * tiles
    span = cdiv(FWD_THREADS - 1, tpr) + 1
    return dict(tiles=tiles, wt=wt, tpr=tpr, rows=min(span, segs),
                xs=(tpr * WPT + LC + 3) & ~3,
                blocks=cdiv(segs * tpr, FWD_THREADS))


def bwd_issued(tg, wsh, w4, wpass, qp):
    threads, quads = tg * wsh, 0
    for p in range(wpass):
        qc = qp if p + 1 < wpass else w4 - qp * (wpass - 1)
        for w in range(cdiv(threads, 32)):
            ws = w * 32 // tg
            quads += cdiv(qc - ws, wsh) if qc > ws else 0
    return quads * 32 * TPT * 4


def bwd_tiling(l, w):
    groups, w4 = cdiv(l, TPT), cdiv(w, 4)
    wpass = cdiv(w4, QMAX)
    qp = cdiv(w4, wpass)
    best, best_cost = None, -1
    for tiles in range(1, min(BWD_TILES_MAX, groups) + 1):
        tg = cdiv(groups, tiles)
        wsh = 1
        while tg * wsh <= BWD_THREADS_MAX:
            cost = tiles * bwd_issued(tg, wsh, w4, wpass, qp)
            d = abs(tg * wsh - 256)
            if (best_cost < 0 or cost < best_cost
                    or (cost == best_cost and tiles == best["tiles"]
                        and d < abs(best["threads"] - 256))):
                best_cost = cost
                best = dict(tiles=tiles, tg=tg, wsh=wsh, threads=tg * wsh)
            wsh += 1
    best.update(block=(best["threads"] + 31) & ~31, wpass=wpass, qp=qp,
                xs=4 * qp + TPT * best["tg"] + 4)
    return best


def batch_chunk(b, c, n):
    """`_batch_chunk` of sie_tpu_torch/ops/shapelet_l1.py."""
    from sie_tpu_torch.ops.shapelet_l1 import _batch_chunk
    return _batch_chunk(b, c, n)


# ------------------------------------------------------- block mappings
def k1_blocks(b, t, n, l):
    """Emulates K1 over one channel: (stores (b, n, W) counts, issued tap
    slots). Checks each block's staged reads and its output copy."""
    w = t - l + 1
    tl = fwd_tiling(b, w)
    ns = fwd_rows(n)
    chunks = cdiv(n, ns)
    items = b * tl["tiles"] * tl["tpr"]
    seg = tl["tpr"] * WPT
    stores = np.zeros((b, n, w), np.int64)
    issued = 0
    for chunk in range(chunks):
        n0 = chunk * ns
        for blk in range(tl["blocks"]):
            q0 = blk * FWD_THREADS
            q1 = min(items, q0 + FWD_THREADS)
            r0 = q0 // tl["tpr"]
            nr = (q1 - 1) // tl["tpr"] + 1 - r0
            assert 1 <= nr <= tl["rows"]
            tid = np.arange(q1 - q0)
            q = q0 + tid
            rr = q // tl["tpr"] - r0
            w0 = (q % tl["tpr"]) * WPT
            assert rr.min() >= 0 and rr.max() < nr
            # reads: three float4 at w0 + l (l <= lc - 4), scalars in the
            # tail: all inside the segment's seg + lc staged floats
            for l0 in range(0, l, LC):
                lc = min(LC, l - l0)
                top = (w0 + (lc & ~3) - 4 + WPT + 4 if lc >= 4 else
                       w0 + lc - 1 + WPT)
                top = np.maximum(top, w0 + lc - 1 + WPT)
                assert top.max() <= seg + lc and seg + lc <= tl["xs"]
            issued += cdiv(q1 - q0, 32) * 32 * WPT * l * ns
            # the output copy: ob[(qa - q0) * WPT + i] is window wa + i of
            # segment sg, written by the thread of item q0 + ob // WPT
            for r in range(nr):
                sg = r0 + r
                bb, tile = divmod(sg, tl["tiles"])
                qa = max(q0, sg * tl["tpr"])
                qb = min(q1, (sg + 1) * tl["tpr"])
                wa = (qa - sg * tl["tpr"]) * WPT
                nw = min((qb - qa) * WPT, min(tl["wt"], w - tile * tl["wt"])
                         - wa)
                if nw <= 0:
                    continue
                ob = (qa - q0) * WPT + np.arange(nw)
                owner = q0 + ob // WPT
                assert (owner // tl["tpr"] - r0 == r).all()
                assert ((owner % tl["tpr"]) * WPT + ob % WPT
                        == wa + np.arange(nw)).all()
                win = tile * tl["wt"] + wa + np.arange(nw)
                assert win.max() < w
                for j in range(ns):
                    if n0 + j < n:
                        stores[bb, n0 + j, win] += 1
    return stores, issued


def k2_blocks(b, t, n, l, bchunk):
    """Emulates K2 over one channel: (adds (n, L, B, W) counts, issued tap
    slots from the warps' busiest lanes). Checks the staged x reads."""
    w = t - l + 1
    tl = bwd_tiling(l, w)
    ns = bwd_rows(n)
    chunks, parts = cdiv(n, ns), cdiv(b, bchunk)
    w4, tt = cdiv(w, 4), TPT * tl["tg"]
    adds = np.zeros((l, b, w), np.int64)
    issued = 0
    tid = np.arange(tl["threads"])
    grp, share = tid % tl["tg"], tid // tl["tg"]
    for tile in range(tl["tiles"]):
        l0 = tile * tt
        taps = l0 + TPT * grp[:, None] + np.arange(TPT)          # (thr, 4)
        for bc in range(parts):
            for bb in range(bc * bchunk, min(b, bc * bchunk + bchunk)):
                for wp in range(tl["wpass"]):
                    qa = wp * tl["qp"]
                    qc = min(tl["qp"], w4 - qa)
                    count = np.array([len(range(sh, qc, tl["wsh"]))
                                      for sh in share])
                    lanes = np.zeros(tl["block"], np.int64)
                    lanes[:len(count)] = count
                    issued += int(lanes.reshape(-1, 32).max(1).sum()) * 32 \
                        * TPT * 4
                    for th in range(tl["threads"]):
                        qs = np.arange(share[th], qc, tl["wsh"])
                        if not len(qs):
                            continue
                        # x read at 4 q + TPT grp + (e + k), e, k < 4
                        assert 4 * qs.max() + TPT * grp[th] + 6 \
                            < 4 * qc + tt + 3 <= tl["xs"]
                        wins = (4 * (qa + qs)[:, None] + np.arange(4)).ravel()
                        wins = wins[wins < w]
                        tp = taps[th][taps[th] < l]
                        adds[np.ix_(tp, [bb], wins)] += 1
    issued *= chunks * ns
    return np.broadcast_to(adds, (n, l, b, w)), issued, tl


# ------------------------------------------------------------- the tests
@pytest.mark.parametrize("l", FLAGSHIP_LENGTHS)
def test_flagship_banks_issue_at_most_5_percent_padded_taps(l):
    b, t, n = FLAGSHIP["B"], FLAGSHIP["T"], FLAGSHIP["n"]
    w = t - l + 1
    useful = n * b * w * l
    # K1: idle lanes of each block's last warp, windows past each row
    tl = fwd_tiling(b, w)
    items = b * tl["tiles"] * tl["tpr"]
    lanes = sum(cdiv(min(items, q0 + FWD_THREADS) - q0, 32) * 32
                for q0 in range(0, items, FWD_THREADS))
    k1 = cdiv(n, fwd_rows(n)) * fwd_rows(n) * lanes * WPT * l
    assert k1 / useful - 1 <= 0.05, (l, k1 / useful)
    # K2: taps past L, windows past W, lanes idle while their warp's
    # busiest share runs
    tb = bwd_tiling(l, w)
    k2 = (cdiv(n, bwd_rows(n)) * bwd_rows(n) * tb["tiles"] * b
          * bwd_issued(tb["tg"], tb["wsh"], cdiv(w, 4), tb["wpass"], tb["qp"]))
    assert k2 / useful - 1 <= 0.05, (l, tb, k2 / useful)


@pytest.mark.parametrize("l", FLAGSHIP_LENGTHS)
def test_flagship_bank_mapping_covers_every_output_once(l):
    """K1's and K2's mappings at a flagship bank, on 3 batch rows; the
    emulated K2's warp-by-warp count equals `bwd_issued`."""
    b, t, n = 3, FLAGSHIP["T"], FLAGSHIP["n"]
    stores, _ = k1_blocks(b, t, n, l)
    assert (stores == 1).all()
    adds, issued, tl = k2_blocks(b, t, n, l, bchunk=2)
    assert (adds == 1).all()
    w = t - l + 1
    assert issued == (cdiv(n, bwd_rows(n)) * bwd_rows(n) * tl["tiles"] * b
                      * bwd_issued(tl["tg"], tl["wsh"], cdiv(w, 4),
                                   tl["wpass"], tl["qp"]))
    assert tl["threads"] <= BWD_THREADS_MAX


@settings(max_examples=30, deadline=None)
@given(t=st.integers(1, 260), frac=st.floats(0.0, 1.0),
       n=st.integers(1, 21), b=st.integers(1, 4))
def test_every_window_tap_and_row_is_covered_once(t, frac, n, b):
    l = max(1, min(t, int(round(frac * t))))
    stores, _ = k1_blocks(b, t, n, l)
    assert (stores == 1).all()
    bchunk = batch_chunk(b, 122, n)
    adds, _, _ = k2_blocks(b, t, n, l, bchunk)
    assert (adds == 1).all()


@pytest.mark.parametrize("t,l", [(1998, 1598), (2500, 300), (5000, 40),
                                 (4097, 2)])
def test_long_rows_split_into_segments_and_passes(t, l):
    """Rows longer than WT_MAX windows (K1) or QMAX quads (K2), and taps past
    the tap tiles' limits, as the EigenWorms-shaped path's polyphase
    components and long series give them: still each output once."""
    stores, _ = k1_blocks(2, t, 3, l)
    assert (stores == 1).all()
    w = t - l + 1
    tl = bwd_tiling(l, w)
    assert tl["wpass"] == cdiv(cdiv(w, 4), QMAX)
    adds, _, _ = k2_blocks(1, t, 3, l, 1)
    assert (adds == 1).all()


def _table_ranges(sizes):
    """The grouped kernels' `start` of each table entry: the blocks of the
    earlier entries."""
    return np.cumsum([0] + list(sizes))


@pytest.mark.parametrize("lengths", [FLAGSHIP_LENGTHS, (5, 11, 23),
                                     (9, 9, 70)])
def test_grouped_tables_give_each_bank_its_own_tiling(lengths):
    """K3 and K4 list the banks by descending L (K3) or work per block (K4)
    and give each its own tiling, as K1 and K2 would; every block id falls
    in exactly one bank's range, and the launch's block size and shared
    memory are the largest bank's."""
    b, t, n, c = 64, 845, 10, 122
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    sizes = [fwd_tiling(b, t - lengths[i] + 1)["blocks"]
             * cdiv(n, max(fwd_rows(n) for _ in lengths)) for i in order]
    starts = _table_ranges(sizes)
    ids = np.arange(starts[-1])
    bank = np.searchsorted(starts, ids, side="right") - 1
    assert (np.bincount(bank, minlength=len(lengths)) == sizes).all()
    tiles = [bwd_tiling(l, t - l + 1) for l in lengths]
    for l, tl in zip(lengths, tiles):
        assert tl["block"] % 32 == 0 and tl["threads"] <= tl["block"]
    block = max(tl["block"] for tl in tiles)
    assert block <= BWD_THREADS_MAX
    bc = [batch_chunk(b, c, n) for _ in lengths]
    assert all(1 <= x <= b for x in bc)
