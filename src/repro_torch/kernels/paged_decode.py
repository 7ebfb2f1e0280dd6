"""Single-query flash decode over the paged BAM KV cache (K4): the CUDA
kernel's wrapper, its plain PyTorch version, and the dense-gather oracle.

``paged_decode_attention`` ports the Pallas TPU kernel
``repro.kernels.paged_decode.paged_decode_attention``. It is driven by
``serving.paged_cache.build_decode_grid``'s step list (req, page, first,
last, active); the wrapper turns the active steps into CSR form
(``DecodeSteps``: row_ptr [B+1], pages) for ``csrc/paged_decode.cu``, in
which one block walks one (row, KV head)'s active pages. Pages a query's
bits cannot reach never reach the kernel. A CPU tensor runs the plain
version ``paged_decode_torch``; a CUDA tensor launches the kernel or
raises.

``paged_decode_ref`` is the serving engine's ``attn="xla"`` path: gather
each row's pages through its page-table row (null-page padded) and run
the dense reference.

``paged_decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bam_attention import DTYPE_CODES, HEAD_DIMS
from repro_torch.kernels.ref import bam_attention_ref, masked_attention


@dataclasses.dataclass(frozen=True)
class DecodeSteps:
    """A decode grid's active steps in CSR form: row ``b``'s active pages
    are ``pages[row_ptr[b]:row_ptr[b+1]]`` (int32 tensors on the
    attention's device)."""
    row_ptr: torch.Tensor
    pages: torch.Tensor


def decode_steps(steps, batch: int, device) -> DecodeSteps:
    """(req, page, first, last, active) step arrays -> ``DecodeSteps``.
    Padding steps (first = last = active = 0) and inactive flush steps
    carry no page and are dropped; each row's active steps must be
    consecutive, as ``build_decode_grid`` lays them out."""
    req, page, _first, _last, active = (np.asarray(s, np.int64)
                                        for s in steps)
    live = active == 1
    req_a = req[live]
    if np.any(np.diff(req_a) < 0) or (req_a.size and req_a.max() >= batch):
        raise ValueError("decode steps: active steps must be grouped by "
                         "row in ascending order, rows < batch")
    row_ptr = np.zeros(batch + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(req_a, minlength=batch))
    return DecodeSteps(
        row_ptr=torch.from_numpy(row_ptr).to(device),
        pages=torch.from_numpy(page[live].astype(np.int32)).to(device))


def paged_decode_torch(q, k_pages, v_pages, q_bits, q_pos, kv_bits, kv_pos,
                       steps: DecodeSteps, *, softcap: float = 0.0,
                       window: int = 0):
    """Plain version of K4: per row, gather its active pages and run the
    kernels' masked softmax (f32 probabilities, as the kernel keeps them)
    over them. Rows with no active page give 0."""
    B, H, hd = q.shape
    ps = k_pages.shape[1]
    out = torch.zeros_like(q)
    row_ptr = steps.row_ptr.tolist()
    for b in range(B):
        pg = steps.pages[row_ptr[b]:row_ptr[b + 1]].long()
        if pg.numel() == 0:
            continue
        n = pg.numel() * ps
        k = k_pages[pg].reshape(1, n, *k_pages.shape[2:])
        v = v_pages[pg].reshape(1, n, *v_pages.shape[2:])
        out[b] = masked_attention(
            q[b][None, None], k, v, q_bits[b:b + 1], kv_bits[pg].reshape(1, n),
            q_pos[b:b + 1], kv_pos[pg].reshape(1, n), softcap=softcap,
            window=window)[0][0, 0]
    return out


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("paged_decode").paged_decode
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 10 + [i] * 6 + [f, f, i, p]
    fn.restype = i
    return fn


def paged_decode_attention(q, k_pages, v_pages, q_bits, q_pos, kv_bits,
                           kv_pos, steps, *, softcap: float = 0.0,
                           window: int = 0):
    """Paged single-query BAM flash decode.

    q: [B, H, hd]; k_pages/v_pages: [P, page_size, Hkv, hd]; q_bits/q_pos:
    [B, 1] int32; kv_bits/kv_pos: [P, page_size] int32; steps: a
    ``DecodeSteps`` or the (req, page, first, last, active) arrays of
    ``build_decode_grid(...).arrays()``. Returns [B, H, hd]; rows with no
    active step are exactly 0.
    """
    B, H, hd = q.shape
    P, page_size, Hkv, hd_k = k_pages.shape
    if hd != hd_k or v_pages.shape != k_pages.shape:
        raise ValueError(f"q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"disagree")
    if H % Hkv:
        raise ValueError(f"GQA needs H % Hkv == 0, got H={H} Hkv={Hkv}")
    if kv_bits.shape != (P, page_size) or kv_pos.shape != (P, page_size):
        raise ValueError(
            f"kv page metadata {tuple(kv_bits.shape)}/{tuple(kv_pos.shape)} "
            f"does not match the page pool ({P}, {page_size})")
    if q_bits.shape != (B, 1) or q_pos.shape != (B, 1):
        raise ValueError(f"q_bits/q_pos must be [B, 1]=({B}, 1), got "
                         f"{tuple(q_bits.shape)}/{tuple(q_pos.shape)}")
    if not isinstance(steps, DecodeSteps):
        steps = decode_steps(steps, B, q.device)
    if q.device.type == "cpu":
        return paged_decode_torch(q, k_pages, v_pages, q_bits, q_pos,
                                  kv_bits, kv_pos, steps, softcap=softcap,
                                  window=window)
    tensors = (q, k_pages, v_pages, q_bits, q_pos, kv_bits, kv_pos,
               steps.row_ptr, steps.pages)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: all inputs must be on "
                         "one CUDA device (or all on the CPU)")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"q/pages must share a dtype in {list(DTYPE_CODES)}")
    if any(t.dtype != torch.int32 for t in tensors[3:]):
        raise ValueError("bits, positions and steps must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention needs contiguous inputs")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("K/V pages must be 16-byte aligned (the kernel "
                         "reads them with 16-byte loads)")
    if hd not in HEAD_DIMS or H // Hkv > 32:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS} or more than "
                         f"32 query heads per KV head")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        q_bits.data_ptr(), q_pos.data_ptr(), kv_bits.data_ptr(),
        kv_pos.data_ptr(), steps.row_ptr.data_ptr(), steps.pages.data_ptr(),
        out.data_ptr(), B, H, Hkv, page_size, hd, DTYPE_CODES[q.dtype],
        hd ** -0.5, float(softcap), int(window), stream)
    _build.check("paged_decode", rc)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_ref(q, k_pages, v_pages, q_bits, q_pos, kv_bits, kv_pos,
                     page_tables, *, softcap: float = 0.0, window: int = 0):
    """Dense-gather decode oracle addressed by page-table rows
    ([B, max_pages] int32, null-page padded)."""
    B, H, hd = q.shape
    P, page_size, Hkv, _ = k_pages.shape
    mp = page_tables.shape[1]
    pt = page_tables.long()
    k = k_pages[pt].reshape(B, mp * page_size, Hkv, hd)
    v = v_pages[pt].reshape(B, mp * page_size, Hkv, hd)
    bits = kv_bits[pt].reshape(B, mp * page_size)
    pos = kv_pos[pt].reshape(B, mp * page_size)
    out = bam_attention_ref(q[:, None], k, v, q_bits, bits, q_pos, pos,
                            softcap=softcap, window=window)
    return out[:, 0]
