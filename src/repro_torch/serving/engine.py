"""Continuous batching engine over the paged BAM decode cache (port of
``repro.serving.engine``).

``step()`` is one scheduler tick: admit waiting requests into free rows
(admission reserves the full prompt + generation page budget up front),
prefill each admission (its K/V go straight into its pages, and it emits
its first token), then run one batched decode step for every occupied
row. Finished requests free their pages, whose bits/pos metadata are
scrubbed on the host and on the device, and their row takes the next
admission. Decoding is greedy, so a request's tokens do not depend on
which other requests share its batch.

Decode attention runs through the dense-gather reference
(``attn="xla"``) or K4 (``attn="kernel"``), whose step list comes from
``build_decode_grid``.

A request submitted with a ``ContextPlan`` is prefilled in plan layout:
its prompt is permuted by the plan (bits and positions travel with
their tokens, so attention is unchanged), its pages record their CP
rank (``plan_page_owners``), and its first token comes from the row
that holds the last prompt token.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import bam
from repro_torch.device import resolve_device
from repro_torch.parallel.plan import ContextPlan
from repro_torch.serving import model as M
from repro_torch.serving.paged_cache import (NULL_PAGE, PageTable,
                                             build_decode_grid,
                                             decode_grid_bucket,
                                             init_paged_cache,
                                             plan_page_owners)


class InfeasibleRequest(ValueError):
    """Raised at ``submit`` for a request whose page budget can never fit
    the pool, even with the engine otherwise empty."""

    def __init__(self, *, prompt_len: int, max_new_tokens: int,
                 needed_pages: int, capacity: int, page_size: int):
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.needed_pages = needed_pages
        self.capacity = capacity
        self.page_size = page_size
        super().__init__(
            f"request needs {needed_pages} pages (prompt {prompt_len} "
            f"tokens + {max_new_tokens} new, page_size {page_size}) "
            f"but the pool only has {capacity} allocatable pages — it "
            f"can never be admitted; shrink the request or grow "
            f"num_pages")


@dataclasses.dataclass
class Request:
    """One generation request. ``tokens``/``bits``/``positions`` cover
    the unpadded prompt; ``gen_bits`` is stamped on every generated
    token."""
    rid: int
    tokens: np.ndarray                      # [T] int32 prompt
    max_new_tokens: int
    bits: Optional[np.ndarray] = None       # [T] int32 (None = causal text)
    positions: Optional[np.ndarray] = None  # [T] int32 (None = arange)
    gen_bits: int = 0
    eos_id: Optional[int] = None
    plan: Optional[ContextPlan] = None      # prefill in ContextPlan layout
    generated: List[int] = dataclasses.field(default_factory=list)
    next_idx: int = 0                       # next logical cache index
    next_pos: int = 0                       # next semantic position
    done: bool = False


class ServingEngine:
    """``model`` must live on ``device``. Wall-clock spans of the two
    phases accumulate in ``prefill_seconds`` / ``decode_seconds`` (each
    ends in a host read of the emitted tokens, so it covers the device
    work) and ``decode_ticks`` counts decode steps."""

    def __init__(self, model, cfg, *, num_pages: int = 64,
                 page_size: int = 16, max_batch: int = 4,
                 attn: str = "xla", device="cuda"):
        self.device = resolve_device(device)
        M.check_serving_cfg(cfg)
        if attn not in M.ATTN_PATHS:
            raise ValueError(f"attn={attn!r}; pick from {M.ATTN_PATHS}")
        self.model = model
        self.cfg = cfg
        self.attn = attn
        self.max_batch = max_batch
        self.table = PageTable(num_pages, page_size)
        self.cache = init_paged_cache(cfg, num_pages, page_size,
                                      device=self.device)
        self.rows: List[Optional[int]] = [None] * max_batch
        self.requests: Dict[int, Request] = {}
        self.queue: deque = deque()
        self._next_rid = 0
        self.grid_window = M.grid_window(cfg)
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.decode_ticks = 0

    # -- submission --------------------------------------------------------

    def submit(self, tokens, *, bits=None, positions=None,
               max_new_tokens: int = 16, eos_id: Optional[int] = None,
               gen_bits: Optional[int] = None, plan=None) -> int:
        """Queue a request; returns its rid. ``bits`` (int32 [T]) carry
        the prompt's BAM bitfields (None = causal text); ``plan``, a
        ``ContextPlan`` covering the page-padded prompt, lays the prompt
        out in plan order."""
        if plan is not None and not isinstance(plan, ContextPlan):
            raise TypeError(f"plan must be a ContextPlan, got "
                            f"{type(plan).__name__}")
        rid = self._next_rid
        r = Request(
            rid=rid, tokens=np.asarray(tokens, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens),
            bits=None if bits is None else
            np.asarray(bits, np.int32).reshape(-1),
            positions=None if positions is None else
            np.asarray(positions, np.int32).reshape(-1),
            gen_bits=int(gen_bits) if gen_bits is not None
            else bam.text_token(),
            eos_id=eos_id, plan=plan)
        if r.bits is not None and len(r.bits) != len(r.tokens):
            raise ValueError(
                f"request {rid}: bits length {len(r.bits)} != prompt "
                f"length {len(r.tokens)}")
        budget = self._page_budget(r)
        capacity = self.table.num_pages - 1      # page 0 is the null page
        if budget > capacity:
            raise InfeasibleRequest(
                prompt_len=len(r.tokens),
                max_new_tokens=r.max_new_tokens,
                needed_pages=budget, capacity=capacity,
                page_size=self.table.page_size)
        self._next_rid += 1
        self.requests[rid] = r
        self.queue.append(rid)
        return rid

    # -- scheduling --------------------------------------------------------

    def _padded_len(self, n: int) -> int:
        ps = self.table.page_size
        return -(-n // ps) * ps

    def _page_budget(self, r: Request) -> int:
        # prompt (page-padded) + every generated token that re-enters
        # the cache as a decode query (the last one never does)
        return self.table.pages_needed(
            self._padded_len(len(r.tokens)) + max(r.max_new_tokens - 1, 0))

    def _admit(self) -> List[int]:
        admitted = []
        while self.queue and None in self.rows:
            r = self.requests[self.queue[0]]
            if self._page_budget(r) > self.table.num_free:
                break   # FIFO: don't starve the head of the queue
            self.queue.popleft()
            self.rows[self.rows.index(None)] = r.rid
            admitted.append(r.rid)
        return admitted

    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill(self, r: Request) -> None:
        """Prompt forward -> K/V written into r's pages; emits the first
        generated token from the last prompt token's logits."""
        T = len(r.tokens)
        Tp = self._padded_len(T)
        self.table.alloc(r.rid, Tp + max(r.max_new_tokens - 1, 0))

        tokens = np.zeros(Tp, np.int32)
        tokens[:T] = r.tokens
        bits = np.zeros(Tp, np.int32)
        bits[:T] = r.bits if r.bits is not None else bam.text_token()
        pos = np.full(Tp, -1, np.int32)
        pos[:T] = r.positions if r.positions is not None \
            else np.arange(T, dtype=np.int32)

        last_row = T - 1
        if r.plan is not None:
            layout = r.plan.apply(Tp)
            perm = layout["perm"]
            tokens, bits, pos = tokens[perm], bits[perm], pos[perm]
            last_row = int(layout["inv_perm"][T - 1])
            owners = plan_page_owners(layout, self.table.page_size)
            self.table.page_owner[self.table.pages_of(r.rid)[:len(owners)]] \
                = owners

        idx = np.arange(Tp)
        self.table.write(r.rid, idx, bits, pos)
        page, slot = self.table.coords(r.rid, idx)
        batch = {"tokens": self._tensor(tokens)[None],
                 "positions": self._tensor(pos)[None],
                 "bits": self._tensor(bits)[None]}
        logits, self.cache = M.paged_prefill(
            self.model, self.cfg, self.cache, batch,
            self._tensor(page), self._tensor(slot))
        r.next_idx = Tp
        r.next_pos = T
        self._emit(r, int(torch.argmax(logits[0, last_row])))

    def _emit(self, r: Request, token: int) -> None:
        r.generated.append(token)
        if (r.eos_id is not None and token == r.eos_id) or \
                len(r.generated) >= r.max_new_tokens:
            r.done = True

    def _retire(self, rid: int) -> None:
        pages = self._tensor(np.asarray(self.table.pages_of(rid), np.int64))
        self.table.free(rid)
        # device scrub: attention masks from cache["bits"]/["pos"], so a
        # reused page must not carry the old request's metadata
        self.cache["bits"][pages] = 0
        self.cache["pos"][pages] = -1
        self.rows[self.rows.index(rid)] = None

    # -- decode ------------------------------------------------------------

    def _decode_batch(self):
        """Batch tensors for one decode tick. Each occupied row inserts
        its last generated token at its next logical index; empty rows
        point at the null page with bits 0."""
        B = self.max_batch
        tokens = np.zeros(B, np.int32)
        pos = np.zeros(B, np.int32)
        qbits = np.zeros(B, np.int32)
        page = np.full(B, NULL_PAGE, np.int32)
        slot = np.zeros(B, np.int32)
        for i, rid in enumerate(self.rows):
            if rid is None:
                continue
            r = self.requests[rid]
            tokens[i] = r.generated[-1]
            pos[i] = r.next_pos
            qbits[i] = r.gen_bits
            self.table.write(r.rid, [r.next_idx], [r.gen_bits],
                             [r.next_pos])
            p, s = self.table.coords(r.rid, [r.next_idx])
            page[i], slot[i] = p[0], s[0]
        batch = {"tokens": self._tensor(tokens)[:, None],
                 "positions": self._tensor(pos)[:, None],
                 "bits": self._tensor(qbits)[:, None],
                 "page": self._tensor(page), "slot": self._tensor(slot)}
        if self.attn == "xla":
            mp = max([1] + [len(self.table.pages_of(rid))
                            for rid in self.rows if rid is not None])
            mp = decode_grid_bucket(mp, granule=4)
            pt = np.stack([
                self.table.page_table_row(rid, mp) if rid is not None
                else np.full(mp, NULL_PAGE, np.int32)
                for rid in self.rows])
            batch["page_tables"] = self._tensor(pt)
        else:
            batch["steps"] = build_decode_grid(
                self.table, self.rows, qbits, pos,
                window=self.grid_window).arrays()
        return batch

    @torch.inference_mode()
    def step(self) -> Dict[int, int]:
        """One scheduler tick. Returns {rid: token} emitted this tick."""
        out: Dict[int, int] = {}
        for rid in self._admit():
            r = self.requests[rid]
            t0 = time.perf_counter()
            self._prefill(r)
            self.prefill_seconds += time.perf_counter() - t0
            out[rid] = r.generated[-1]
            if r.done:
                self._retire(rid)
        if not any(rid is not None for rid in self.rows):
            return out
        t0 = time.perf_counter()
        batch = self._decode_batch()
        logits, self.cache = M.paged_decode_step(
            self.model, self.cfg, self.cache, batch, attn=self.attn)
        next_tok = torch.argmax(logits[:, 0], dim=-1).tolist()
        self.decode_seconds += time.perf_counter() - t0
        self.decode_ticks += 1
        for i, rid in enumerate(self.rows):
            if rid is None:
                continue
            r = self.requests[rid]
            r.next_idx += 1
            r.next_pos += 1
            self._emit(r, int(next_tok[i]))
            out[rid] = r.generated[-1]
            if r.done:
                self._retire(rid)
        return out

    @property
    def pending(self) -> bool:
        return bool(self.queue) or \
            any(rid is not None for rid in self.rows)

    def run(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        """Drive ``step()`` until every submitted request completes;
        returns {rid: generated tokens}."""
        ticks = 0
        while self.pending:
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"engine did not drain within {max_ticks} ticks "
                    f"(queue={len(self.queue)}, rows={self.rows})")
            self.step()
        return {rid: list(r.generated)
                for rid, r in self.requests.items()}
