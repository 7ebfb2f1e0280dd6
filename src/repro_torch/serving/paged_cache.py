"""Paged KV cache for decode serving (port of
``repro.serving.paged_cache``): a host-side page table and a device pool.

* ``PageTable`` (host, numpy) owns the free list, each request's
  logical-token -> (physical page, slot) mapping, and host mirrors of
  the per-slot BAM bitfields and positions.
* ``init_paged_cache`` allocates the pool on the device: ``k``/``v``
  [L, P, page_size, Hkv, hd] and the ``bits``/``pos`` [P, page_size]
  slot metadata the decode kernel masks from.

Page 0 is the reserved null page: its bits stay 0, so padded page-table
entries and empty batch rows point at it and mask out.

``build_decode_grid`` turns the table and the rows' query bitfields into
the step list K4 consumes: per request, only the pages its bitfield can
reach (``bam.build_block_map`` with block_q=1, block_k=page_size).

A prompt prefilled in ContextPlan layout has its pages' CP ranks
recorded in ``PageTable.page_owner`` (``plan_page_owners``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bam
from repro_torch.device import resolve_device

#: reserved all-zero-bits page every padded/inactive reference points at
NULL_PAGE = 0


class PageTable:
    """Free-list page allocator + logical->physical token mapping, shared
    by all layers. All state is host numpy."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages={num_pages}: need at least the null page "
                f"plus one allocatable page")
        if page_size < 1:
            raise ValueError(f"page_size={page_size} must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self.bits = np.zeros((num_pages, page_size), np.int32)
        self.pos = np.full((num_pages, page_size), -1, np.int32)
        #: CP rank of each page's slots after a plan-layout prefill (-1 =
        #: none); informational, attention never reads it
        self.page_owner = np.full(num_pages, -1, np.int32)
        self._free: List[int] = list(range(num_pages - 1, NULL_PAGE, -1))
        self._pages: Dict[int, List[int]] = {}
        self._len: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def pages_of(self, rid: int) -> List[int]:
        return list(self._pages[rid])

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, rid: int, n_tokens: int) -> List[int]:
        """Grow ``rid``'s page list to hold ``n_tokens`` tokens; returns
        the new pages. Raises RuntimeError when the pool is exhausted."""
        pages = self._pages.setdefault(rid, [])
        self._len.setdefault(rid, 0)
        need = self.pages_needed(n_tokens) - len(pages)
        if need > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: request {rid} needs {need} more "
                f"pages for {n_tokens} tokens but only {len(self._free)} "
                f"of {self.num_pages - 1} allocatable pages are free")
        new = [self._free.pop() for _ in range(max(need, 0))]
        pages.extend(new)
        return new

    def free(self, rid: int) -> None:
        """Release ``rid``'s pages, scrubbing the host mirrors (the engine
        scrubs the device metadata)."""
        for p in self._pages.pop(rid, ()):
            self.bits[p] = 0
            self.pos[p] = -1
            self.page_owner[p] = -1
            self._free.append(p)
        self._len.pop(rid, None)

    def coords(self, rid: int, idx) -> Tuple[np.ndarray, np.ndarray]:
        """Logical token indices -> (physical page, slot) arrays."""
        idx = np.asarray(idx, np.int64)
        pages = np.asarray(self._pages[rid], np.int32)
        if idx.size and int(idx.max()) >= len(pages) * self.page_size:
            raise IndexError(
                f"request {rid}: token index {int(idx.max())} exceeds "
                f"allocated capacity {len(pages) * self.page_size}")
        return pages[idx // self.page_size], \
            (idx % self.page_size).astype(np.int32)

    def write(self, rid: int, idx, bits, pos) -> None:
        """Record tokens in the host mirrors."""
        page, slot = self.coords(rid, idx)
        self.bits[page, slot] = np.asarray(bits, np.int32)
        self.pos[page, slot] = np.asarray(pos, np.int32)
        idx = np.asarray(idx, np.int64)
        if idx.size:
            self._len[rid] = max(self._len[rid], int(idx.max()) + 1)

    def kv_view(self, rid: int) -> Tuple[np.ndarray, np.ndarray]:
        """The request's KV metadata, page-padded, as flat arrays."""
        pages = self._pages[rid]
        return self.bits[pages].reshape(-1), self.pos[pages].reshape(-1)

    def page_table_row(self, rid: int, max_pages: int) -> np.ndarray:
        """Dense [max_pages] physical-page row, null-page padded."""
        pages = self._pages[rid]
        if len(pages) > max_pages:
            raise ValueError(
                f"request {rid} holds {len(pages)} pages > "
                f"max_pages={max_pages}")
        row = np.full(max_pages, NULL_PAGE, np.int32)
        row[:len(pages)] = pages
        return row


def init_paged_cache(cfg, num_pages: int, page_size: int, *, device="cuda"):
    """Device page pool: ``k``/``v`` [L, P, page_size, Hkv, hd] in the
    model's dtype (Hkv honours ``decode_kv_replicate``) and
    ``bits``/``pos`` [P, page_size] int32 slot metadata."""
    from repro_torch.models.transformer import _cache_cfg, torch_dtype
    dev = resolve_device(device)
    ccfg = _cache_cfg(cfg)
    dtype = torch_dtype(cfg)
    shape = (cfg.num_layers, num_pages, page_size, ccfg.num_kv_heads,
             ccfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "bits": torch.zeros((num_pages, page_size), dtype=torch.int32,
                                device=dev),
            "pos": torch.full((num_pages, page_size), -1, dtype=torch.int32,
                              device=dev)}


@dataclasses.dataclass(frozen=True)
class DecodeGrid:
    """Flattened decode step list: one step = (batch row ``req``,
    physical page, first, last, active), each request's steps
    consecutive. ``active == 0`` steps flush a request with no reachable
    page or pad the list to ``pad_to``."""
    page_size: int
    window: int
    req: np.ndarray
    page: np.ndarray
    first: np.ndarray
    last: np.ndarray
    active: np.ndarray
    n_dense_steps: int

    def arrays(self):
        return (self.req, self.page, self.first, self.last, self.active)


def build_decode_grid(table: PageTable, rids: Sequence[Optional[int]],
                      q_bits, q_pos, *, window: int = 0,
                      pad_to: Optional[int] = None) -> DecodeGrid:
    """Active-page step list for one decode batch. ``rids[i]`` occupies
    row i (None = empty row: one inactive flush step on the null page);
    ``q_bits``/``q_pos`` [B] are the rows' current query tokens, already
    written into the table so each query attends itself."""
    q_bits = np.asarray(q_bits, np.int64)
    q_pos = np.asarray(q_pos, np.int32)
    if len(rids) != len(q_bits) or len(rids) != len(q_pos):
        raise ValueError(
            f"rids/q_bits/q_pos disagree on batch size: "
            f"{len(rids)}/{len(q_bits)}/{len(q_pos)}")
    req, page, first, last, active = [], [], [], [], []
    n_dense = 0
    for i, rid in enumerate(rids):
        if rid is None:
            req.append(i)
            page.append(NULL_PAGE)
            first.append(1)
            last.append(1)
            active.append(0)
            continue
        pages = table.pages_of(rid)
        n_dense += len(pages)
        kv_bits, kv_pos = table.kv_view(rid)
        bm = bam.build_block_map(
            q_bits[i:i + 1], kv_bits, q_pos[i:i + 1], kv_pos,
            block_q=1, block_k=table.page_size, window=window)
        for (_iq, ik, f, l, a) in bm.q_steps:
            req.append(i)
            page.append(pages[ik] if a else NULL_PAGE)
            first.append(f)
            last.append(l)
            active.append(a)
    if pad_to is not None:
        if pad_to < len(req):
            raise ValueError(
                f"pad_to={pad_to} < {len(req)} real decode steps")
        n_pad = pad_to - len(req)
        req += [0] * n_pad
        page += [NULL_PAGE] * n_pad
        first += [0] * n_pad
        last += [0] * n_pad
        active += [0] * n_pad
    return DecodeGrid(
        page_size=table.page_size, window=window,
        req=np.asarray(req, np.int32), page=np.asarray(page, np.int32),
        first=np.asarray(first, np.int32), last=np.asarray(last, np.int32),
        active=np.asarray(active, np.int32), n_dense_steps=n_dense)


def plan_page_owners(layout: Dict, page_size: int) -> np.ndarray:
    """CP rank of each page of a prompt written in ContextPlan layout.

    ``layout`` is ``ContextPlan.apply(seq_len)``'s dict; slot j of the
    prompt holds source token ``perm[j]`` and the ranks' slot counts
    differ by at most one, so each rank's tokens are a contiguous run of
    slots. Returns [n_pages] int32 rank ids; a page straddling two runs
    belongs to the rank of its first slot."""
    n = len(layout["perm"])
    ranks = int(layout["num_ranks"])
    base, extra = divmod(n, ranks)
    counts = [base + (1 if r < extra else 0) for r in range(ranks)]
    slot_rank = np.repeat(np.arange(ranks, dtype=np.int32), counts)
    return slot_rank[np.arange(-(-n // page_size)) * page_size]


def decode_grid_bucket(n_steps: int, granule: int = 16) -> int:
    """Round a step count up to a multiple of ``granule``."""
    return max(granule, -(-n_steps // granule) * granule)
