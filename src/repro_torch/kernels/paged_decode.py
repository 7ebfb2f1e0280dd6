"""Single-query flash decode over the paged BAM KV cache (K4): the CUDA
kernel's wrapper, its plain PyTorch version, and the dense-gather oracle.

``paged_decode_attention`` ports the Pallas TPU kernel
``repro.kernels.paged_decode.paged_decode_attention``. It is driven by
``serving.paged_cache.build_decode_grid``'s step list (req, page, first,
last, active); ``decode_steps`` turns the active steps into CSR form
(``DecodeSteps``: row_ptr [B+1], pages) once per tick on the host, and
cuts each row's pages into splits (the kernel's work list: one block per
split and KV head) so that a few long rows still spread over every SM of
the card. ``csrc/paged_decode.cu`` streams each split's pages through
shared memory and merges a row's splits in a fixed order. Pages a
query's bits cannot reach never reach the kernel. A CPU tensor runs the
plain version ``paged_decode_torch``; a CUDA tensor launches the kernel
or raises.

``paged_decode_ref`` is the serving engine's ``attn="xla"`` path: gather
each row's pages through its page-table row (null-page padded) and run
the dense reference.

``paged_decode_attention.launches`` counts the wrapper's kernel calls.
The kernel takes head sizes ``HEAD_DIMS`` (64, 128 and 256) within the
page-size and GQA caps that ``k4_caps`` states for each.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bam_attention import DTYPE_CODES
from repro_torch.kernels.ref import bam_attention_ref, masked_attention


# The split planner's aim: 3 blocks per SM of an H100 (132 SMs), and no
# split shorter than 2 of the kernel's stages of STAGE_KEYS keys (a
# shorter one costs a merge more than it saves).
TARGET_BLOCKS = 396
STAGE_KEYS = 32
MIN_SPLIT_STAGES = 2

HEAD_DIMS = (64, 128, 256)   # what K4 takes (no path reaches it at 80)
MAX_PAGE_SIZE = 64   # a stage of the kernel's 3-stage ring holds one such page
MAX_REP = 32         # query heads per KV head: one warp each


def k4_caps(hd: int) -> tuple:
    """(largest page size, most query heads per KV head) that K4 takes
    at head size ``hd``, in either dtype (csrc/paged_decode.cu ``Caps``).
    At hd 256 a 3-stage ring of 64-key stages would not fit in shared
    memory, so pages stop at STAGE_KEYS slots, and a block of 32 warps
    would spill registers, so the heads stop at 16. Raises
    ``ValueError`` for a head size the kernel does not take."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if hd <= 128:
        return MAX_PAGE_SIZE, MAX_REP
    return STAGE_KEYS, 16


@dataclasses.dataclass(frozen=True)
class DecodeSteps:
    """A decode grid's active steps in CSR form: row ``b``'s active pages
    are ``pages[row_ptr[b]:row_ptr[b+1]]``. The kernel's work list: row
    ``b``'s splits are ``splits[split_ptr[b]:split_ptr[b+1]]``, each a
    (row, first index into ``pages``, page count) triple, consecutive and
    in page order; ``empty`` lists the rows with no active page;
    ``tickets`` are the kernel's B x Hkv counters, zero between calls
    (the kernel resets them), so calls that share one ``DecodeSteps`` run
    one after another on one stream. All are int32 views of one tensor
    on the attention's device."""
    row_ptr: torch.Tensor
    pages: torch.Tensor
    split_ptr: torch.Tensor
    splits: torch.Tensor
    empty: torch.Tensor
    tickets: torch.Tensor


def pages_per_split(total_pages: int, kv_heads: int, page_size: int) -> int:
    """The split size for ``total_pages`` active pages, in whole stages of
    the kernel (a stage holds STAGE_KEYS keys: max(1, STAGE_KEYS //
    page_size) pages): as many stages as still give ``want =
    ceil(TARGET_BLOCKS / kv_heads)`` splits, and at least
    MIN_SPLIT_STAGES. So splits x kv_heads >= TARGET_BLOCKS whenever the
    pages fill MIN_SPLIT_STAGES stages per wanted split, and about half
    of it when they fill only one."""
    want = -(-TARGET_BLOCKS // kv_heads)
    stage = max(1, STAGE_KEYS // page_size)
    stages = -(-total_pages // stage)
    return max(MIN_SPLIT_STAGES, stages // want) * stage


def split_rows(row_ptr: np.ndarray, pps: int):
    """Cut each CSR row into splits of at most ``pps`` pages. Returns
    (split_ptr [B+1], splits [S, 3]: row, first index, page count), int32;
    a row with no page has no split."""
    counts = np.diff(row_ptr)
    n_split = -(-counts // pps)
    split_ptr = np.zeros(len(counts) + 1, np.int64)
    split_ptr[1:] = np.cumsum(n_split)
    row = np.repeat(np.arange(len(counts)), n_split)
    first = row_ptr[row] + (np.arange(len(row)) - split_ptr[row]) * pps
    count = np.minimum(pps, row_ptr[row + 1] - first)
    splits = np.stack([row, first, count], axis=1)
    return split_ptr.astype(np.int32), splits.astype(np.int32)


def decode_steps(steps, batch: int, device, *, kv_heads: int,
                 page_size: int) -> DecodeSteps:
    """(req, page, first, last, active) step arrays -> ``DecodeSteps`` for
    a cache of ``kv_heads`` KV heads and pages of ``page_size`` slots.
    Padding steps (first = last = active = 0) and inactive flush steps
    carry no page and are dropped; each row's active steps must be
    consecutive, as ``build_decode_grid`` lays them out. The split size
    comes from the step arrays, ``kv_heads`` and ``page_size`` alone
    (``pages_per_split``), so the same steps always give the same blocks.
    Everything goes to ``device`` in one copy."""
    req, page, _first, _last, active = (np.asarray(s, np.int64)
                                        for s in steps)
    live = active == 1
    req_a = req[live]
    if np.any(np.diff(req_a) < 0) or (req_a.size and req_a.max() >= batch):
        raise ValueError("decode steps: active steps must be grouped by "
                         "row in ascending order, rows < batch")
    row_ptr = np.zeros(batch + 1, np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(req_a, minlength=batch))
    split_ptr, splits = split_rows(row_ptr, pages_per_split(
        int(row_ptr[-1]), kv_heads, page_size))
    empty = np.flatnonzero(row_ptr[1:] == row_ptr[:-1])
    parts = (row_ptr, page[live], split_ptr, splits.ravel(), empty,
             np.zeros(batch * kv_heads, np.int64))
    flat = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(device)
    views, at = [], 0
    for a in parts:
        views.append(flat[at:at + a.size])
        at += a.size
    row_ptr_t, pages_t, split_ptr_t, splits_t, empty_t, tickets_t = views
    return DecodeSteps(row_ptr=row_ptr_t, pages=pages_t,
                       split_ptr=split_ptr_t, splits=splits_t.view(-1, 3),
                       empty=empty_t, tickets=tickets_t)


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
    fn.argtypes = [p] * 14 + [i] * 7 + [f, f, i, p]
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
        steps = decode_steps(steps, B, q.device, kv_heads=Hkv,
                             page_size=page_size)
    if steps.row_ptr.numel() != B + 1 or steps.tickets.numel() != B * Hkv:
        raise ValueError(f"steps are for {steps.row_ptr.numel() - 1} rows "
                         f"and {steps.tickets.numel()} (row, KV head) "
                         f"pairs, q has {B} rows of {Hkv} KV heads")
    if q.device.type == "cpu":
        return paged_decode_torch(q, k_pages, v_pages, q_bits, q_pos,
                                  kv_bits, kv_pos, steps, softcap=softcap,
                                  window=window)
    tensors = (q, k_pages, v_pages, q_bits, q_pos, kv_bits, kv_pos,
               steps.pages, steps.split_ptr, steps.splits, steps.empty,
               steps.tickets)
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
                         "copies them in 16-byte pieces)")
    max_page, max_rep = k4_caps(hd)
    if H // Hkv > max_rep or page_size > max_page:
        raise ValueError(f"K4 at head_dim {hd} takes pages of at most "
                         f"{max_page} slots and at most {max_rep} query "
                         f"heads per KV head; got page size {page_size}, "
                         f"{H // Hkv} heads per KV head")
    n_splits, n_empty = steps.splits.shape[0], steps.empty.numel()
    out = torch.empty_like(q)
    scratch = torch.empty(n_splits * H * (hd + 2), dtype=torch.float32,
                          device=q.device)
    rc = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        q_bits.data_ptr(), q_pos.data_ptr(), kv_bits.data_ptr(),
        kv_pos.data_ptr(), steps.pages.data_ptr(),
        steps.split_ptr.data_ptr(), steps.splits.data_ptr(),
        steps.empty.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        steps.tickets.data_ptr(), n_splits, n_empty, H, Hkv, page_size, hd,
        DTYPE_CODES[q.dtype], hd ** -0.5, float(softcap), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
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
