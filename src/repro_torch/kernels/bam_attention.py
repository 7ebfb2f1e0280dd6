"""BAM flash attention: the CUDA kernels' wrappers and their plain
PyTorch versions.

- K1, ``bam_flash_attention``: the counterpart of the Pallas TPU kernel
  ``repro.kernels.bam_attention.bam_flash_attention`` on its dense grid,
  modes ``"out"``, ``"residual"`` (``(out, lse)``) and ``"stats"`` (the
  unnormalised ``(acc, m, l)`` context parallelism combines across
  chunks of keys); ``csrc/bam_fwd.cu``.
- K2, ``bam_bwd_dq``, and K3, ``bam_bwd_dkv``: the two halves of
  ``bam_flash_attention_bwd`` (dQ; dK/dV folded over GQA) on its dense
  grid; ``csrc/bam_bwd_dq.cu`` and ``csrc/bam_bwd_dkv.cu``. Both
  recompute P from the forward's lse and take delta = rowsum(dO·O)
  (``bwd_delta``, plain PyTorch) as an input.

Each takes ``block_map=`` (a ``core.bam.BlockMask`` built at the
kernels' own tile, ``BLOCK_Q`` x ``BLOCK_K`` = 64 x 32): the compacted
grid, the counterpart of the Pallas kernels' ``block_map`` path
(``_bam_fwd_kernel_sparse``, ``_bam_bwd_dq_kernel_sparse``,
``_bam_bwd_dkv_kernel_sparse``). The kernels then walk only the active
tiles of the map's CSR rows (``core.bam.block_csr``): q-major for K1 and
K2, k-major for K3 (on its wgmma body, whose block owns 64 keys, the union
of each pair of k-major rows). Pairs outside the map's tiles count as
masked, so the plain versions AND the mask with ``core.bam.tile_mask``.

Head sizes (``kernel_body``): the kernels take ``HEAD_DIMS`` = 64, 80,
128 and 256. bf16 runs the wgmma bodies (Hopper's tensor cores) at every
one of them (80 padded to 128 in shared memory); f32 runs the SIMT
bodies (f32 FMAs out of padded shared memory). Any other head size
raises ``ValueError`` on a CUDA tensor.

The [T, T] mask is never materialised by a kernel: each tile of it is
evaluated from the int32 bitfield and position vectors. A CPU tensor
runs the plain version (``*_torch``); a CUDA tensor launches the kernel
or raises. Each kernel wrapper counts its launches in ``.launches``;
K1 counts its stats-mode launches apart, in ``.stats_launches``, and
every wrapper counts its compacted launches (any mode) apart, in
``.compact_launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import bam
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (NEG_INF, masked_attention,  # noqa: F401
                                     masked_stats)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128, 256)      # what K1, K2 and K3 take
RETURN_MODES = ("out", "residual", "stats")
# the kernels' tile (csrc/*.cu: BQ x BK), which a block map must share
BLOCK_Q, BLOCK_K = 64, 32


def check_block_map(block_map, Tq: int, Tk: int, window: int) -> None:
    """Refuse a map the kernels cannot walk: another tile, a grid that is
    not ceil(T / tile), or another window (tiles valid under this window
    may have been pruned). The counterpart of the Pallas wrapper's
    ``_check_block_map``."""
    if (block_map.block_q, block_map.block_k) != (BLOCK_Q, BLOCK_K):
        raise ValueError(
            f"block_map was built for tile {block_map.block_q} x "
            f"{block_map.block_k}; the kernels' tile is {BLOCK_Q} x "
            f"{BLOCK_K}")
    grid = (-(-Tq // BLOCK_Q), -(-Tk // BLOCK_K))
    if (block_map.nq, block_map.nk) != grid:
        raise ValueError(f"block_map grid {(block_map.nq, block_map.nk)} "
                         f"does not match Tq={Tq}, Tk={Tk}: want {grid}")
    if block_map.window != window:
        raise ValueError(f"block_map was built for window "
                         f"{block_map.window}, the call has {window}")


def kernel_body(hd: int, dtype, kernel: str) -> str:
    """The body of ``kernel`` ("K1", "K2" or "K3") that a CUDA call at
    head size ``hd`` in ``dtype`` runs: ``"wgmma"`` (bf16; the same rule
    for all three) or ``"simt"`` (f32). Raises ``ValueError`` for another
    kernel or a head size the kernels do not take."""
    if kernel not in ("K1", "K2", "K3"):
        raise ValueError(f"kernel {kernel!r} not in ('K1', 'K2', 'K3')")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def _tiles(block_map, q, k, major: str):
    """The plain versions' restriction to the map's tiles (None without
    a map)."""
    if block_map is None:
        return None
    return bam.tile_mask(block_map, q.shape[1], k.shape[1], q.device, major)


def _csr_args(block_map, device, major: str):
    """(row pointers, column indices) for a launch, of the q-major
    (``"q"``), k-major (``"k"``) or 64-key k-major (``"k64"``) rows;
    (None, None) on the dense grid."""
    if block_map is None:
        return None, None
    csr = bam.block_csr(block_map, device)
    ptr, idx = {"q": (csr.q_ptr, csr.q_cols), "k": (csr.k_ptr, csr.k_rows),
                "k64": (csr.k64_ptr, csr.k64_rows)}[major]
    return ptr.data_ptr(), idx.data_ptr()


def bam_flash_attention_torch(q, k, v, q_bits, kv_bits, q_pos, kv_pos, *,
                              softcap: float = 0.0, window: int = 0,
                              return_mode: str = "out", block_map=None):
    """Plain version of K1: dense masked softmax in f32 with the kernel's
    conventions (rows with no allowed key give out = 0, lse = -1e30; in
    stats mode m = -1e30, l = 0, acc = 0). With ``block_map``, only the
    pairs inside its active tiles are allowed."""
    tiles = _tiles(block_map, q, k, "q")
    if return_mode == "stats":
        # (acc [B,H,Tq,hd], m, l) in f32, p multiplying V in f32
        mask = bam.allowed_mask(q_bits, kv_bits, q_pos, kv_pos, window)
        if tiles is not None:
            mask = mask & tiles
        return masked_stats(q, k, v, mask[:, None], softcap=softcap)
    out, lse = masked_attention(q, k, v, q_bits, kv_bits, q_pos, kv_pos,
                                softcap=softcap, window=window, tiles=tiles)
    return out if return_mode == "out" else (out, lse)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("bam_fwd").bam_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    f = ctypes.c_float
    fn.argtypes = [p] * 12 + [i] * 7 + [f, f, i, p]
    fn.restype = i
    return fn


def _check_inputs(q, k, v, q_bits, kv_bits, q_pos, kv_pos):
    B, Tq, H, hd = q.shape
    _, Tk, Hkv, _ = k.shape
    if k.shape != (B, Tk, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"GQA needs H % Hkv == 0, got H={H} Hkv={Hkv}")
    if q_bits.shape != (B, Tq) or q_pos.shape != (B, Tq):
        raise ValueError(f"q_bits/q_pos must be [B, Tq]=({B}, {Tq})")
    if kv_bits.shape != (B, Tk) or kv_pos.shape != (B, Tk):
        raise ValueError(f"kv_bits/kv_pos must be [B, Tk]=({B}, {Tk})")


def bam_flash_attention(q, k, v, q_bits, kv_bits, q_pos, kv_pos, *,
                        softcap: float = 0.0, window: int = 0,
                        return_mode: str = "out", block_map=None):
    """BAM attention forward. q: [B,Tq,H,hd]; k/v: [B,Tk,Hkv,hd]; bits
    and positions int32 [B,T*]. Any Tq, Tk (the kernel masks its own
    ragged edge). Returns out [B,Tq,H,hd], or (out, lse [B,H,Tq] f32)
    for ``return_mode="residual"``, or for ``return_mode="stats"`` the
    f32 (acc [B,H,Tq,hd], m [B,H,Tq], l [B,H,Tq]) with acc = Σ exp(s -
    m)·V over allowed keys (the kernel writes acc in that layout
    itself). With ``block_map`` the compacted grid: each q block walks
    only its active k tiles, ascending."""
    if return_mode not in RETURN_MODES:
        raise ValueError(f"return_mode={return_mode!r}; pick from "
                         f"{RETURN_MODES}")
    _check_inputs(q, k, v, q_bits, kv_bits, q_pos, kv_pos)
    if block_map is not None:
        check_block_map(block_map, q.shape[1], k.shape[1], window)
    if q.device.type == "cpu":
        return bam_flash_attention_torch(
            q, k, v, q_bits, kv_bits, q_pos, kv_pos, softcap=softcap,
            window=window, return_mode=return_mode, block_map=block_map)
    tensors = (q, k, v, q_bits, kv_bits, q_pos, kv_pos)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("bam_flash_attention: all inputs must be on one "
                         "CUDA device (or all on the CPU)")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share a dtype in "
                         f"{list(DTYPE_CODES)}, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if any(t.dtype != torch.int32 for t in tensors[3:]):
        raise ValueError("bits and positions must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bam_flash_attention needs contiguous inputs")
    B, Tq, H, hd = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    kernel_body(hd, q.dtype, "K1")
    stats = return_mode == "stats"
    row = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, Tq, hd), **row) if stats else torch.empty_like(q)
    lse = torch.empty((B, H, Tq), **row) if return_mode != "out" else None
    lsum = torch.empty((B, H, Tq), **row) if stats else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_bits.data_ptr(),
        kv_bits.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        None if lsum is None else lsum.data_ptr(),
        *_csr_args(block_map, q.device, "q"),
        B, Tq, Tk, H, Hkv, hd, DTYPE_CODES[q.dtype], hd ** -0.5,
        float(softcap), int(window), stream)
    _build.check("bam_fwd", rc)
    if block_map is not None:
        bam_flash_attention.compact_launches += 1
    elif stats:
        bam_flash_attention.stats_launches += 1
    else:
        bam_flash_attention.launches += 1
    if stats:
        return out, lse, lsum
    return out if return_mode == "out" else (out, lse)


bam_flash_attention.launches = 0
bam_flash_attention.stats_launches = 0
bam_flash_attention.compact_launches = 0


# ---------------------------------------------------------------------------
# Backward: K2 (dQ) and K3 (dK/dV)
# ---------------------------------------------------------------------------

def bwd_delta(out, do):
    """delta = rowsum(dO·O) in f32, [B,H,Tq] (outside the kernels, as
    the TPU wrapper computes it)."""
    return torch.einsum("bqhd,bqhd->bhq", out.float(), do.float()).contiguous()


def _p_ds(q, k, v, do, lse, delta, q_bits, kv_bits, q_pos, kv_pos,
          softcap, window, tiles=None):
    """Dense f32 recompute of P = exp(s - lse) on allowed pairs (0
    elsewhere, by select: an empty row's lse is -1e30) and dS = P (dP -
    delta), times 1 - (s/cap)^2 under a softcap; ``tiles`` [Tq, Tk]
    restricts the allowed pairs to a block map's. Returns (p, ds)
    [B,H,Tq,Tk] and the GQA-expanded f32 k."""
    n_rep = q.shape[2] // k.shape[2]
    kf = bam.repeat_kv(k, n_rep).float()
    vf = bam.repeat_kv(v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * q.shape[-1] ** -0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = bam.allowed_mask(q_bits, kv_bits, q_pos, kv_pos, window)
    if tiles is not None:
        mask = mask & tiles
    mask = mask[:, None]
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1.0 - (s / softcap) ** 2)
    return p, ds, kf


def _dq_from(ds, kf, q):
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf)
            * q.shape[-1] ** -0.5).to(q.dtype)


def _dkv_from(p, ds, q, do, k):
    B, Tk, Hkv, hd = k.shape
    n_rep = q.shape[2] // Hkv
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * hd ** -0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    fold = (B, Tk, Hkv, n_rep, hd)
    return (dk.reshape(fold).sum(3).to(k.dtype),
            dv.reshape(fold).sum(3).to(k.dtype))


def bam_bwd_dq_torch(q, k, v, do, lse, delta, q_bits, kv_bits, q_pos,
                     kv_pos, *, softcap: float = 0.0, window: int = 0,
                     block_map=None):
    """Plain version of K2: dQ [B,Tq,H,hd] in q's dtype, f32 inside; with
    ``block_map`` over the pairs of its q-major tiles only."""
    _, ds, kf = _p_ds(q, k, v, do, lse, delta, q_bits, kv_bits, q_pos,
                      kv_pos, softcap, window, _tiles(block_map, q, k, "q"))
    return _dq_from(ds, kf, q)


def bam_bwd_dkv_torch(q, k, v, do, lse, delta, q_bits, kv_bits, q_pos,
                      kv_pos, *, softcap: float = 0.0, window: int = 0,
                      block_map=None):
    """Plain version of K3: (dK, dV) [B,Tk,Hkv,hd] in k's dtype, summed
    over the query heads of each KV head in f32; with ``block_map`` over
    the pairs of its k-major tiles only (a k block with none gives
    zeros)."""
    p, ds, _ = _p_ds(q, k, v, do, lse, delta, q_bits, kv_bits, q_pos,
                     kv_pos, softcap, window, _tiles(block_map, q, k, "k"))
    return _dkv_from(p, ds, q, do, k)


def bam_flash_attention_bwd_torch(q, k, v, out, do, lse, q_bits, kv_bits,
                                  q_pos, kv_pos, *, softcap: float = 0.0,
                                  window: int = 0):
    """Plain version of the backward pair: (dq, dk, dv) from the forward's
    (out, lse), with P recomputed once."""
    delta = bwd_delta(out, do)
    p, ds, kf = _p_ds(q, k, v, do, lse, delta, q_bits, kv_bits, q_pos,
                      kv_pos, softcap, window)
    return (_dq_from(ds, kf, q), *_dkv_from(p, ds, q, do, k))


@functools.lru_cache(maxsize=None)
def _bwd_entry(name: str, n_out: int):
    fn = getattr(_build.library(name), name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * (12 + n_out) + [i] * 7 + [f, f, i, p]
    fn.restype = i
    return fn


def _check_bwd(q, k, v, do, lse, delta, q_bits, kv_bits, q_pos, kv_pos,
               block_map, window, kernel: str):
    """Shapes and the block map always; device, dtype and layout for a
    launch (returns True when the inputs are on the CPU and the plain
    version runs)."""
    _check_inputs(q, k, v, q_bits, kv_bits, q_pos, kv_pos)
    B, Tq, H, hd = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    if lse.shape != (B, H, Tq) or delta.shape != (B, H, Tq):
        raise ValueError(f"lse/delta must be [B, H, Tq]=({B}, {H}, {Tq})")
    if block_map is not None:
        check_block_map(block_map, Tq, k.shape[1], window)
    if q.device.type == "cpu":
        return True
    tensors = (q, k, v, do, lse, delta, q_bits, kv_bits, q_pos, kv_pos)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("BAM backward: all inputs must be on one CUDA "
                         "device (or all on the CPU)")
    if (q.dtype not in DTYPE_CODES
            or any(t.dtype != q.dtype for t in (k, v, do))):
        raise ValueError(f"q/k/v/do must share a dtype in {list(DTYPE_CODES)}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError("lse and delta must be float32")
    if any(t.dtype != torch.int32 for t in tensors[6:]):
        raise ValueError("bits and positions must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the BAM backward kernels need contiguous inputs")
    kernel_body(hd, q.dtype, kernel)
    return False


def _bwd_args(q, k, v, do, lse, delta, q_bits, kv_bits, q_pos, kv_pos):
    return [t.data_ptr() for t in (q, k, v, do, lse, delta, q_bits, kv_bits,
                                   q_pos, kv_pos)]


def _bwd_scalars(q, k, softcap, window):
    B, Tq, H, hd = q.shape
    return (B, Tq, k.shape[1], H, k.shape[2], hd, DTYPE_CODES[q.dtype],
            hd ** -0.5, float(softcap), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)


def _count(fn, block_map) -> None:
    if block_map is None:
        fn.launches += 1
    else:
        fn.compact_launches += 1


def bam_bwd_dq(q, k, v, do, lse, delta, q_bits, kv_bits, q_pos, kv_pos, *,
               softcap: float = 0.0, window: int = 0, block_map=None):
    """K2: dQ [B,Tq,H,hd] in q's dtype from q, k/v [B,Tk,Hkv,hd], dO, the
    forward's lse and delta (f32 [B,H,Tq]). Any Tq, Tk. With
    ``block_map`` each q block walks only its active k tiles."""
    args = (q, k, v, do, lse, delta, q_bits, kv_bits, q_pos, kv_pos)
    kw = dict(softcap=softcap, window=window, block_map=block_map)
    if _check_bwd(*args, block_map, window, "K2"):
        return bam_bwd_dq_torch(*args, **kw)
    dq = torch.empty_like(q)
    rc = _bwd_entry("bam_bwd_dq", 1)(
        *_bwd_args(*args), dq.data_ptr(),
        *_csr_args(block_map, q.device, "q"),
        *_bwd_scalars(q, k, softcap, window))
    _build.check("bam_bwd_dq", rc)
    _count(bam_bwd_dq, block_map)
    return dq


bam_bwd_dq.launches = 0
bam_bwd_dq.compact_launches = 0


def bam_bwd_dkv(q, k, v, do, lse, delta, q_bits, kv_bits, q_pos, kv_pos, *,
                softcap: float = 0.0, window: int = 0, block_map=None):
    """K3: (dK, dV) [B,Tk,Hkv,hd] in k's dtype, folded over the query
    heads of each KV head inside the kernel (no atomics: the same bits
    every run). Any Tq, Tk. With ``block_map`` each block walks only its
    active q blocks, each as two 32-row tiles: on the SIMT body a 32-key
    block its k-major row, on the wgmma body a 64-key block the union of
    its two k-major rows (``k64_ptr``/``k64_rows``), masking a half's
    pairs in a q block its own row does not list."""
    args = (q, k, v, do, lse, delta, q_bits, kv_bits, q_pos, kv_pos)
    kw = dict(softcap=softcap, window=window, block_map=block_map)
    if _check_bwd(*args, block_map, window, "K3"):
        return bam_bwd_dkv_torch(*args, **kw)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _bwd_entry("bam_bwd_dkv", 2)(
        *_bwd_args(*args), dk.data_ptr(), dv.data_ptr(),
        *_csr_args(block_map, q.device,
                   "k64" if kernel_body(q.shape[3], q.dtype, "K3") == "wgmma"
                   else "k"),
        *_bwd_scalars(q, k, softcap, window))
    _build.check("bam_bwd_dkv", rc)
    _count(bam_bwd_dkv, block_map)
    return dk, dv


bam_bwd_dkv.launches = 0
bam_bwd_dkv.compact_launches = 0


def bam_flash_attention_bwd(q, k, v, out, do, lse, q_bits, kv_bits, q_pos,
                            kv_pos, *, softcap: float = 0.0,
                            window: int = 0, block_map=None):
    """BAM flash-attention backward from the forward's (out, lse): dq
    [B,Tq,H,hd] in q's dtype, dk/dv [B,Tk,Hkv,hd] in k's dtype. K2 and
    K3 on a CUDA tensor (compacted with ``block_map``), their plain
    versions on a CPU tensor; no O(Tq·Tk) tensor outside the plain
    versions."""
    delta = bwd_delta(out, do)
    args = (q, k, v, do, lse, delta, q_bits, kv_bits, q_pos, kv_pos)
    kw = dict(softcap=softcap, window=window, block_map=block_map)
    return (bam_bwd_dq(*args, **kw), *bam_bwd_dkv(*args, **kw))
