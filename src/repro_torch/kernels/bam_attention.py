"""BAM flash-attention forward (K1): the CUDA kernel's wrapper and its
plain PyTorch version.

``bam_flash_attention`` is the port of the Pallas TPU kernel
``repro.kernels.bam_attention.bam_flash_attention`` on its dense grid,
modes ``"out"`` and ``"residual"`` (``(out, lse)``). The kernel itself is
``csrc/bam_fwd.cu``: the [T, T] mask is never materialised, each tile of
it is evaluated from the int32 bitfield and position vectors inside the
kernel. A CPU tensor runs the plain version ``bam_flash_attention_torch``;
a CUDA tensor launches the kernel or raises.

``bam_flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, masked_attention

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
RETURN_MODES = ("out", "residual")


def bam_flash_attention_torch(q, k, v, q_bits, kv_bits, q_pos, kv_pos, *,
                              softcap: float = 0.0, window: int = 0,
                              return_mode: str = "out"):
    """Plain version of K1: dense masked softmax in f32 with the kernel's
    conventions (rows with no allowed key give out = 0, lse = -1e30)."""
    out, lse = masked_attention(q, k, v, q_bits, kv_bits, q_pos, kv_pos,
                                softcap=softcap, window=window)
    return out if return_mode == "out" else (out, lse)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("bam_fwd").bam_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    f = ctypes.c_float
    fn.argtypes = [p] * 9 + [i] * 7 + [f, f, i, p]
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
                        return_mode: str = "out"):
    """BAM attention forward. q: [B,Tq,H,hd]; k/v: [B,Tk,Hkv,hd]; bits
    and positions int32 [B,T*]. Any Tq, Tk (the kernel masks its own
    ragged edge). Returns out [B,Tq,H,hd], or (out, lse [B,H,Tq] f32)
    for ``return_mode="residual"``."""
    if return_mode not in RETURN_MODES:
        raise ValueError(f"return_mode={return_mode!r}; the port has "
                         f"{RETURN_MODES} (stats mode is a later slice)")
    _check_inputs(q, k, v, q_bits, kv_bits, q_pos, kv_pos)
    if q.device.type == "cpu":
        return bam_flash_attention_torch(
            q, k, v, q_bits, kv_bits, q_pos, kv_pos, softcap=softcap,
            window=window, return_mode=return_mode)
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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_mode == "residual" else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_bits.data_ptr(),
        kv_bits.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        B, Tq, Tk, H, Hkv, hd, DTYPE_CODES[q.dtype], hd ** -0.5,
        float(softcap), int(window), stream)
    _build.check("bam_fwd", rc)
    bam_flash_attention.launches += 1
    return out if return_mode == "out" else (out, lse)


bam_flash_attention.launches = 0
