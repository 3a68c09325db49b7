"""The bf16 attention kernels' shared-memory layout and wgmma operands,
emulated in numpy, so that a layout error shows on the CPU.

`csrc/attention_common.cuh` stages 64-row bf16 tiles in wgmma's 128-byte
swizzle (TMA boxes, `tma_tile`, or element by element, `sw_index` and
`load_tile_sw`) and reads them through matrix descriptors (`sw_desc`,
`mma_abt`, `mma_ab`). This file takes the layout
constants from that header, writes tiles as the loader writes them, and
reads every operand as the hardware reads a descriptor (PTX ISA, "Matrix
Descriptor" and the canonical K-major / MN-major layouts with 128-byte
swizzle: the swizzle XORs address bits 4-6 with bits 7-9). It then runs
each of the five products of K5 and K6 (S = Q K^T, dP = dO V^T, dQ = dS K,
S^T = K Q^T, dV = P^T dO) through those reads and holds them against
numpy products of the matrices; and it checks that the score accumulators,
packed by `pack_a`, are wgmma's register A fragments. No CUDA is needed.
"""

import os
import re

import numpy as np
import pytest

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "sie_tpu_torch", "csrc", "attention_common.cuh")
with open(HEADER) as fh:
    SRC = fh.read()


def _const(name: str) -> int:
    m = re.search(rf"constexpr uint32_t {name} = (\d+);", SRC)
    assert m, f"{name} not found in attention_common.cuh"
    return int(m.group(1))


ROW = _const("SW_ROW_BYTES")          # 128
ATOM = _const("SW_ATOM_BYTES")        # 1024: SBO
PANEL = _const("SW_PANEL_BYTES")      # 8192: LBO of MN-major operands
KSTEP_K = _const("KSTEP_KMAJOR_BYTES")      # 32
KSTEP_MN = _const("KSTEP_MNMAJOR_BYTES")    # 2048
KMAJOR_LBO = _const("KMAJOR_LBO_BYTES")


def sw_index(row, col):
    """`sw_index` of the header: the element offset of (row, col) in a
    staged tile."""
    return ((col >> 6) * (PANEL // 2) + row * (ROW // 2)
            + ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7))


def load_tile(mat, t0, dkp):
    """`load_tile_sw`: rows t0 .. t0 + 63 of mat (T, dk) into a tile of 64 x
    dkp elements, zero past T and past dk (a float64 array standing for the
    bf16 words)."""
    t, dk = mat.shape
    tile = np.full(64 * dkp, np.nan)
    for rr in range(64):
        for cc in range(dkp):
            r = t0 + rr
            tile[sw_index(rr, cc)] = mat[r, cc] if r < t and cc < dk else 0.0
    return tile


def swizzle(addr):
    """The 128-byte swizzle on a byte address: bits 4-6 ^= bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def desc_fields(start: int, lbo: int, base: int = 0):
    """`sw_desc` of a tile at byte `base` of a 1024-aligned window, moved
    by `start - base` bytes as the kernels move it (an integer added to
    the descriptor): the 14-bit start address, LBO and SBO fields (16-byte
    units) and the layout type; each field must fit its bits."""
    d = (((base & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((ATOM >> 4) << 32)
         | (1 << 62)) + ((start - base) >> 4)
    fields = ((d & 0x3FFF) << 4, ((d >> 16) & 0x3FFF) << 4,
              ((d >> 32) & 0x3FFF) << 4, d >> 62)
    assert fields == (start, lbo, ATOM, 1)
    return fields


def read_kmajor(tile, start):
    """The 64 x 16 operand a K-major swizzled descriptor at byte `start`
    addresses: element (m, k) at start + (m / 8) SBO + (m % 8) 128 + 2 k."""
    addr_start, _, sbo, _ = desc_fields(start, KMAJOR_LBO)
    m = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    addr = addr_start + (m // 8) * sbo + (m % 8) * ROW + 2 * k
    return tile[swizzle(addr) // 2]


def read_mnmajor(tile, start):
    """The 16 x 64 operand (k, n) an MN-major swizzled descriptor at byte
    `start` addresses: n runs along a 128-byte row, 8 k rows a 1024-byte
    atom, atoms SBO apart, 64-wide n panels LBO apart."""
    addr_start, lbo, sbo, _ = desc_fields(start, PANEL)
    k = np.arange(16)[:, None]
    n = np.arange(64)[None, :]
    addr = (addr_start + (n // 64) * lbo + (k // 8) * sbo + (k % 8) * ROW
            + 2 * (n % 64))
    return tile[swizzle(addr) // 2]


def mma_abt(a_tile, b_tile, dkp):
    """`mma_abt`: A B^T over dkp columns, k-step kk at byte offset (kk / 4)
    panels + (kk % 4) 32 of both tiles."""
    d = np.zeros((64, 64))
    for kk in range(dkp // 16):
        off = (kk // 4) * PANEL + (kk % 4) * KSTEP_K
        d += read_kmajor(a_tile, off) @ read_kmajor(b_tile, off).T
    return d


def mma_ab(a, b_tile, dkp):
    """`mma_ab` over every panel: A (64 x 64, registers) times the tile
    read MN-major, k-step kk at row 16 kk of panel p."""
    d = np.zeros((64, dkp))
    for p in range(dkp // 64):
        for kk in range(4):
            b = read_mnmajor(b_tile, p * PANEL + kk * KSTEP_MN)
            d[:, 64 * p:64 * p + 64] += a[:, 16 * kk:16 * kk + 16] @ b
    return d


def test_the_emulation_mirrors_the_header():
    """The offsets above are the kernels' own: the header computes them
    with these expressions."""
    assert "(kk / 4) * SW_PANEL_BYTES + (kk % 4) * KSTEP_KMAJOR_BYTES" in SRC
    assert "sw_desc(a, KMAJOR_LBO_BYTES)" in SRC
    assert "da + (off >> 4), db + (off >> 4)" in SRC
    assert "sw_desc(b, SW_PANEL_BYTES)" in SRC
    assert "(p * SW_PANEL_BYTES + kk * KSTEP_MNMAJOR_BYTES) >> 4" in SRC
    assert ("((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7)" in SRC)
    assert (ROW, ATOM, PANEL) == (128, 8 * ROW, 64 * ROW)


@pytest.mark.parametrize("dkp", [64, 128])
def test_a_tile_is_a_permutation_and_one_swizzle_period_is_conflict_free(dkp):
    """Every element of a 64 x dkp tile has its own word; the eight rows of
    one 16-byte column chunk fall in eight distinct 16-byte bank groups."""
    idx = np.array([[sw_index(r, c) for c in range(dkp)] for r in range(64)])
    assert sorted(idx.ravel()) == list(range(64 * dkp))
    for c in range(0, dkp, 8):
        groups = {(sw_index(r, c) * 2 % 128) // 16 for r in range(8)}
        assert len(groups) == 8


@pytest.mark.parametrize("dkp", [64, 128])
def test_tma_boxes_write_the_loader_layout(dkp):
    """`tma_tile` stages a tile as dkp / 64 boxes of 64 x 64 in the 128-byte
    swizzle, box p at panel p: the hardware puts element (r, c) of box p at
    byte p * SW_PANEL_BYTES + swizzle(128 r + 2 c) of the 1024-aligned tile,
    which is where `sw_index` (the element loader) puts (r, 64 p + c)."""
    assert "dst + p * (SW_PANEL_BYTES / 2)" in SRC
    assert '"r"(64 * p), "r"(t0), "r"(bh)' in SRC
    assert "const cuuint32_t box[3] = {64, 64, 1}" in SRC
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in SRC
    for p in range(dkp // 64):
        for r in range(64):
            for c in range(64):
                tma = p * PANEL + swizzle(ROW * r + 2 * c)
                assert tma == 2 * sw_index(r, 64 * p + c)


def _matrices(seed, t, dk):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=(t, dk)) for n in ("q", "k", "v", "do")}


# (name, A, B, the product's kind): the five products of K5 and K6; dP^T =
# V dO^T and dK = dS^T Q take the same shapes and reads as S^T and dV
PRODUCTS = ["S=QK^T", "dP=dOV^T", "dQ=dSK", "S^T=KQ^T", "dV=P^TdO"]


@pytest.mark.parametrize("dk", [8, 30, 64, 100, 128])
@pytest.mark.parametrize("product", PRODUCTS)
def test_each_product_reads_the_right_elements(product, dk):
    """Tiles of a ragged T (the second tile of T = 100 holds 36 rows) and
    zero-padded dk, written by the loader and read through the
    descriptors, give the products of the matrices themselves."""
    dkp = 64 if dk <= 64 else 128
    t, t0 = 100, 64
    m = _matrices(dk, t, dk)
    pad = {n: np.zeros((64, dkp)) for n in m}
    for n, x in m.items():
        pad[n][:t - t0, :dk] = x[t0:]
    tiles = {n: load_tile(x, t0, dkp) for n, x in m.items()}
    rng = np.random.default_rng(7)
    ds = rng.normal(size=(64, 64))   # register A operand (dS, P^T)
    if product == "S=QK^T":
        got, want = mma_abt(tiles["q"], tiles["k"], dkp), pad["q"] @ pad["k"].T
    elif product == "dP=dOV^T":
        got, want = (mma_abt(tiles["do"], tiles["v"], dkp),
                     pad["do"] @ pad["v"].T)
    elif product == "dQ=dSK":
        got, want = mma_ab(ds, tiles["k"], dkp), ds @ pad["k"]
    elif product == "S^T=KQ^T":
        got, want = mma_abt(tiles["k"], tiles["q"], dkp), pad["k"] @ pad["q"].T
    else:
        got, want = mma_ab(ds, tiles["do"], dkp), ds @ pad["do"]
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_score_accumulators_are_the_register_a_fragments():
    """wgmma m64n64 accumulators: warp w, lane 4g + i holds d[4j + e] =
    (16w + g + 8(e / 2), 8j + 2i + (e & 1)). A register A fragment of
    k-step kk: register r holds (16w + g + 8(r % 2), 16kk + 8(r / 2) + 2i
    + h) in half h. `pack_a` packs chunks 2kk, 2kk + 1 as (c0[0], c0[1]),
    (c0[2], c0[3]), (c1[0], c1[1]), (c1[2], c1[3])."""
    assert re.search(r"a\[0\] = pack_bf16\(c0\[0\], c0\[1\]\);\s*"
                     r"a\[1\] = pack_bf16\(c0\[2\], c0\[3\]\);\s*"
                     r"a\[2\] = pack_bf16\(c1\[0\], c1\[1\]\);\s*"
                     r"a\[3\] = pack_bf16\(c1\[2\], c1\[3\]\);", SRC)
    packed = [((0, 0), (0, 1)), ((0, 2), (0, 3)), ((1, 0), (1, 1)),
              ((1, 2), (1, 3))]   # (chunk 2kk + c, element e) per half
    seen = set()
    for w in range(4):
        for lane in range(32):
            g, i = lane // 4, lane % 4
            for kk in range(4):
                for r in range(4):
                    for h in range(2):
                        c, e = packed[r][h]
                        acc = (16 * w + g + 8 * (e // 2),
                               8 * (2 * kk + c) + 2 * i + (e & 1))
                        frag = (16 * w + g + 8 * (r % 2),
                                16 * kk + 8 * (r // 2) + 2 * i + h)
                        assert acc == frag
                        seen.add(frag)
    assert len(seen) == 64 * 64   # every element of P once
