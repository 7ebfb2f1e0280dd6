"""hd 80 on the wgmma bodies of K1 and K3 (``csrc/bam_mma.cuh``), emulated
in numpy on the CPU.

A bf16 tile of R rows and 80 columns is laid into the 128-byte-swizzled
[R][128] layout by ``cp_async_tile``'s thread map: 16 chunks of 8
elements a row, chunk c of row r at ``sw128_offset(r, c)``, chunks 10-15
written as zeros. The tensor cores read that memory through the
hardware's swizzle (address bits [4, 7) xor [7, 10)), emulated here from
the descriptors the kernels build, independently of ``sw128_offset``:

- K-major (the reduction over hd: Q·K^T in K1, K·Q^T and V·dO^T in K3):
  5 k16 steps over the padded tiles give Q·K^T of the 80 columns;
- MN-major (N = hd: P·V in K1, P^T·dO and dS^T·Q in K3): the N 128
  product's first 80 columns give P·V, and its last 48 are zeros.

Products of bf16 values are exact in float64 and the sums here are short,
so the checks are exact.
"""
import numpy as np
import pytest

HD, HP = 80, 128          # the head size and its padded layout
CHUNK = 8                 # bf16 elements a 16-byte chunk


def sw128_offset(rows: int, r: int, c: int) -> int:
    """``bam_mma.cuh::sw128_offset<ROWS>``: byte offset of chunk c of row
    r in a swizzled [rows][HP] tile."""
    return (c >> 3) * (rows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4)


def bf16_values(rng, shape):
    """Standard normal values rounded to bf16 (kept in float64)."""
    x = rng.standard_normal(shape).astype(np.float32)
    bits = x.view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.view(np.float32).astype(np.float64)


def lay_tile(src, nt: int = 128):
    """``cp_async_tile<R, 80, nt>``: thread tid copies chunk tid % 16 of
    rows tid / 16 + (nt / 16) i; a chunk at or past 10 is written as
    zeros (src_bytes 0). Returns the tile's memory, one float per bf16
    element (index = byte address / 2), and how often each chunk was
    written."""
    rows = src.shape[0]
    cpr = HP // CHUNK
    rpp = nt // cpr
    mem = np.full(rows * HP, np.nan)
    writes = np.zeros((rows, cpr), dtype=int)
    for tid in range(nt):
        c, r0 = tid % cpr, tid // cpr
        for i in range(rows // rpp):
            r = r0 + i * rpp
            at = sw128_offset(rows, r, c) // 2
            real = c < HD // CHUNK
            mem[at:at + CHUNK] = (src[r, c * CHUNK:(c + 1) * CHUNK] if real
                                  else 0.0)
            writes[r, c] += 1
    return mem, writes


def hw_read(mem, byte_addr: int) -> float:
    """The element at a logical byte address of a tile whose start is on
    a 1024-byte boundary, through the 128-byte swizzle."""
    phys = byte_addr ^ (((byte_addr >> 7) & 7) << 4)
    return mem[phys // 2]


def k_major(mem, rows: int, kk: int):
    """The [rows][16] operand of k16 step kk read by a K-major descriptor
    at ``(kk >> 2) * (rows * 128) + (kk & 3) * 32`` bytes (the kernels'
    issue loops): rows 128 bytes apart, 8-row groups 1024 apart."""
    base = (kk >> 2) * (rows * 128) + (kk & 3) * 32
    return np.array([[hw_read(mem, base + r * 128 + 2 * k)
                      for k in range(16)] for r in range(rows)])


def mn_major(mem, rows: int, kk: int, n: int = HP):
    """The [16][n] B operand of k16 step kk (rows kk*16 .. +16 of the
    tile) read by an MN-major descriptor at ``kk * 16 * 128`` bytes with
    a leading byte offset of ``rows * 128`` (one 64-column block to the
    next)."""
    base = kk * 16 * 128
    return np.array([[hw_read(mem, base + (j >> 6) * (rows * 128) + k * 128
                              + 2 * (j & 63))
                      for j in range(n)] for k in range(16)])


@pytest.mark.parametrize("rows,nt", [(64, 128), (32, 128), (32, 256),
                                     (64, 256)])
def test_every_chunk_written_once(rows, nt):
    """K1's Q (64 rows) and K/V (32), K3's K/V (64) and Q/dO (32), by one
    warpgroup or two: each chunk once, its real values where they belong
    and zeros in chunks 10-15."""
    src = bf16_values(np.random.default_rng(rows + nt), (rows, HD))
    mem, writes = lay_tile(src, nt)
    assert (writes == 1).all()
    for r in range(rows):
        for c in range(HP // CHUNK):
            at = sw128_offset(rows, r, c) // 2
            want = (src[r, c * CHUNK:(c + 1) * CHUNK] if c < HD // CHUNK
                    else np.zeros(CHUNK))
            np.testing.assert_array_equal(mem[at:at + CHUNK], want)


def test_five_k_steps_give_the_scores():
    """S = A·B^T over hd from 5 k16 steps of the padded tiles (K1: Q 64
    rows, K 32; K3: K 64 rows, Q 32) equals the 80-column product, and
    the 3 steps the kernels skip read only zeros."""
    rows_a, rows_b = 64, 32
    rng = np.random.default_rng(7)
    a, b = bf16_values(rng, (rows_a, HD)), bf16_values(rng, (rows_b, HD))
    ma, _ = lay_tile(a)
    mb, _ = lay_tile(b)
    s = sum(k_major(ma, rows_a, kk) @ k_major(mb, rows_b, kk).T
            for kk in range(HD // 16))
    np.testing.assert_array_equal(s, a @ b.T)
    for kk in range(HD // 16, HP // 16):
        assert not k_major(ma, rows_a, kk).any()
        assert not k_major(mb, rows_b, kk).any()


def test_n128_product_keeps_the_first_80_columns():
    """P [64][32] times the padded [32][128] tile (K1's P·V over a 32-key
    tile; K3's P^T·dO and dS^T·Q over a 32-row q tile), two k16 steps at
    N 128: columns 0-79 are P·V, columns 80-127 zeros."""
    rows_p, rows_v = 64, 32
    rng = np.random.default_rng(11 + rows_v)
    p, v = bf16_values(rng, (rows_p, rows_v)), bf16_values(rng, (rows_v, HD))
    mv, _ = lay_tile(v)
    out = sum(p[:, 16 * kk:16 * kk + 16] @ mn_major(mv, rows_v, kk)
              for kk in range(rows_v // 16))
    np.testing.assert_array_equal(out[:, :HD], p @ v)
    assert not out[:, HD:].any()
