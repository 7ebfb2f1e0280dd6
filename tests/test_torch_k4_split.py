"""The design of K4's CUDA kernel (``csrc/paged_decode.cu``), held on the
CPU: the host split planner of ``kernels/paged_decode.py`` and the
kernel's split-and-combine arithmetic.

The kernel cuts each row's active pages into splits (``decode_steps``:
``pages_per_split`` and ``split_rows``); one block per (split, KV head)
runs the online softmax over stages of 32 keys (32 / page_size pages),
scores in f32 from the inputs' values, forbidden keys selected to p = 0,
and leaves f32 partials (m, l, acc); the row's splits are then merged in
ascending split order, weighed against their max m. ``k4_emulated``
repeats that arithmetic in PyTorch and is held against the plain version
``paged_decode_torch`` and the JAX package's Pallas kernel in interpret
mode on ``tests/test_torch_kernels.py``'s paged fixture, over pages per
split {1, 2, 3, whole row}, GQA 4/4, 4/2, 8/2, softcap {0, 20} and
window {0, 4}: f32 within ``ATOL`` (2e-5; only the order of f32 sums
differs). The grids are built without the window, so at window 4 the
early pages stay in the step list and give splits with no allowed key:
their partials are exactly (-1e30, 0, 0), and the merge gives no NaN.
In bf16 (inputs rounded to bf16, the kernel's widths: hd 64 and 128,
page size 16) the emulation, before its final rounding, must use at
most a quarter of the card's rule ``chip_smoke.compare`` (one bf16 ulp
of the element).
"""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import compare  # noqa: E402
from repro.kernels.paged_decode import \
    paged_decode_attention as j_paged  # noqa: E402
from repro.serving import build_decode_grid as j_build_grid  # noqa: E402
from repro_torch.core import bam  # noqa: E402
from repro_torch.kernels.bam_attention import NEG_INF  # noqa: E402
from repro_torch.kernels.paged_decode import (  # noqa: E402
    MIN_SPLIT_STAGES, STAGE_KEYS, TARGET_BLOCKS, decode_steps,
    pages_per_split, paged_decode_attention, paged_decode_torch, split_rows)
from repro_torch.serving import PageTable, build_decode_grid  # noqa: E402
from tests.test_serving import LAYOUTS  # noqa: E402
from tests.test_torch_kernels import ATOL, _paged_fixture  # noqa: E402

SPLIT_MAX = 0.25
PPS = [1, 2, 3, "row"]
GQA = [(4, 4), (4, 2), (8, 2)]


# ---------------------------------------------------------------------------
# the host split planner
# ---------------------------------------------------------------------------

def _steps(lengths):
    """(req, page, first, last, active) arrays for rows of ``lengths``
    active pages (0: an empty row, one inactive flush step), pages
    numbered 1.. in order, and two padding steps at the end."""
    req, page, active = [], [], []
    nxt = 1
    for r, n in enumerate(lengths):
        if n == 0:
            req.append(r)
            page.append(0)
            active.append(0)
        for _ in range(n):
            req.append(r)
            page.append(nxt)
            active.append(1)
            nxt += 1
    req += [0, 0]
    page += [0, 0]
    active += [0, 0]
    ones = np.ones(len(req), np.int64)
    return (np.array(req), np.array(page), ones, ones, np.array(active))


def _check_plan(s, lengths, pps):
    row_ptr = s.row_ptr.numpy()
    splits = s.splits.numpy()
    split_ptr = s.split_ptr.numpy()
    # every active page exactly once, in order
    covered = np.concatenate(
        [s.pages.numpy()[f:f + c] for _, f, c in splits]
        or [np.zeros(0, np.int32)])
    np.testing.assert_array_equal(covered, s.pages.numpy())
    assert s.pages.tolist() == list(range(1, sum(lengths) + 1))
    assert (splits[:, 2] >= 1).all() and (splits[:, 2] <= pps).all()
    for b, n in enumerate(lengths):
        mine = splits[split_ptr[b]:split_ptr[b + 1]]
        assert (mine[:, 0] == b).all()
        # no split crosses its row, and the row's splits run in order
        assert (mine[:, 1] >= row_ptr[b]).all()
        assert (mine[:, 1] + mine[:, 2] <= row_ptr[b + 1]).all()
        assert (np.diff(mine[:, 1]) > 0).all()
        assert len(mine) == -(-n // pps)         # empty rows: no split
    assert s.empty.tolist() == [b for b, n in enumerate(lengths) if n == 0]


ROWS = [[5, 0, 3, 1], [1500 // 16 + 1, 0, 43, 45], [513, 257, 65, 2],
        [0, 0], [7], [8] * 16, [4000, 3000, 2000, 1000]]


@pytest.mark.parametrize("pps", [1, 2, 3, 7, 1000])
@pytest.mark.parametrize("lengths", ROWS)
def test_split_rows_cover_every_page_once(lengths, pps):
    row_ptr = np.concatenate([[0], np.cumsum(lengths)])
    split_ptr, splits = split_rows(row_ptr, pps)
    assert split_ptr.dtype == splits.dtype == np.int32
    assert split_ptr[-1] == len(splits)
    s = decode_steps(_steps(lengths), len(lengths), "cpu", kv_heads=1,
                     page_size=16)
    s = dataclasses.replace(s, split_ptr=torch.from_numpy(split_ptr),
                            splits=torch.from_numpy(splits))
    _check_plan(s, lengths, pps)


@pytest.mark.parametrize("page_size", [8, 16, 64])
@pytest.mark.parametrize("kv_heads", [1, 2, 8, 32])
@pytest.mark.parametrize("lengths", ROWS)
def test_planner_reaches_the_target(lengths, kv_heads, page_size):
    """Splits are whole stages, at least MIN_SPLIT_STAGES of them; splits
    x kv_heads >= TARGET_BLOCKS when the pages fill MIN_SPLIT_STAGES
    stages per wanted split; the same steps always give the same plan."""
    s = decode_steps(_steps(lengths), len(lengths), "cpu",
                     kv_heads=kv_heads, page_size=page_size)
    total = sum(lengths)
    stage = max(1, STAGE_KEYS // page_size)
    pps = pages_per_split(total, kv_heads, page_size)
    assert pps % stage == 0 and pps >= MIN_SPLIT_STAGES * stage
    _check_plan(s, lengths, pps)
    n = s.splits.shape[0]
    stages = -(-total // stage)
    want = -(-TARGET_BLOCKS // kv_heads)
    if stages >= MIN_SPLIT_STAGES * want:
        assert n * kv_heads >= TARGET_BLOCKS
    else:
        assert pps == MIN_SPLIT_STAGES * stage
        assert n >= (stages - 1) / MIN_SPLIT_STAGES
    again = decode_steps(_steps(lengths), len(lengths), "cpu",
                         kv_heads=kv_heads, page_size=page_size)
    for a, b in zip(dataclasses.astuple(s), dataclasses.astuple(again)):
        assert torch.equal(a, b)


def test_decode_steps_is_one_tensor():
    """row_ptr, pages, the splits, the empty rows and the kernel's B x Hkv
    zeroed ticket counters are views of one tensor: one copy to the
    device per tick, and each tick's calls count on counters of their
    own."""
    s = decode_steps(_steps([5, 0, 3]), 3, "cpu", kv_heads=2, page_size=16)
    views = [getattr(s, f.name) for f in dataclasses.fields(s)]
    assert len({t.untyped_storage().data_ptr() for t in views}) == 1
    assert all(t.dtype == torch.int32 for t in views)
    assert s.tickets.tolist() == [0] * 6


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------

def k4_emulated(q, k_pages, v_pages, q_bits, q_pos, kv_bits, kv_pos, steps,
                *, softcap: float = 0.0, window: int = 0):
    """K4's arithmetic, unrounded. Per split of ``steps``: the online
    softmax over stages of 32 keys (32 / page_size pages), scores in f32
    from the inputs' values, forbidden keys selected to p = 0, f32
    partials (m [H], l [H], acc [H, hd]). Per row: a single split is
    normalised as it is; more are merged in ascending order, each
    weighed by exp(m - M) against the splits' max M; out = acc / L (0
    where L = 0). Returns (out f32 [B, H, hd], [(row, m, l, acc)] per split)."""
    B, H, hd = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    head = torch.arange(H) // (H // Hkv)          # query head -> KV head
    sp = max(1, STAGE_KEYS // ps)
    qf = q.float()
    parts = []
    for row, first, count in steps.splits.tolist():
        m = torch.full((H,), NEG_INF)
        l = torch.zeros(H)
        acc = torch.zeros(H, hd)
        pages = steps.pages[first:first + count].long()
        for s0 in range(0, count, sp):
            pg = pages[s0:s0 + sp]
            k = k_pages[pg].reshape(-1, Hkv, hd).float()[:, head]
            v = v_pages[pg].reshape(-1, Hkv, hd).float()[:, head]
            ok = bam.allowed_mask(q_bits[row:row + 1],
                                  kv_bits[pg].reshape(1, -1),
                                  q_pos[row:row + 1],
                                  kv_pos[pg].reshape(1, -1),
                                  window)[0, 0]                    # [n]
            x = torch.einsum("hd,nhd->hn", qf[row], k) * hd ** -0.5
            if softcap:
                x = torch.tanh(x / softcap) * softcap
            x = torch.where(ok, x, torch.full_like(x, NEG_INF))
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(x - m_new[:, None]),
                            torch.zeros_like(x))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + torch.einsum("hn,nhd->hd", p, v)
            m = m_new
        parts.append((row, m, l, acc))
    out = torch.zeros(B, H, hd)
    split_ptr = steps.split_ptr.tolist()
    for b in range(B):
        mine = parts[split_ptr[b]:split_ptr[b + 1]]
        if not mine:
            continue
        if len(mine) == 1:                         # written directly
            _, M, L, o = mine[0]
        else:                                      # ascending split order
            M = torch.stack([m for _, m, _, _ in mine]).amax(0)
            L = torch.zeros(H)
            o = torch.zeros(H, hd)
            for _, m, l, acc in mine:
                wgt = torch.exp(m - M)
                L = L + wgt * l
                o = o + wgt[:, None] * acc
        out[b] = torch.where(L[:, None] > 0, o / L.clamp_min(1e-30)[:, None],
                             torch.zeros_like(o))
    return out, parts


def _with_pps(steps, pps):
    """``steps`` with its rows cut into splits of ``pps`` pages ("row":
    one split per row)."""
    row_ptr = steps.row_ptr.numpy().astype(np.int64)
    if pps == "row":
        pps = max(1, int(np.diff(row_ptr).max()))
    split_ptr, splits = split_rows(row_ptr, pps)
    return dataclasses.replace(steps, split_ptr=torch.from_numpy(split_ptr),
                               splits=torch.from_numpy(splits))


PAGE_SIZE, HD = 8, 16


@functools.lru_cache(maxsize=None)
def _fixture(H, Hkv):
    """tests/test_torch_kernels.py's paged fixture (LAYOUTS, one empty
    row), with grids built without the window."""
    jt, tt, k, v = _paged_fixture(PAGE_SIZE, Hkv, HD)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(len(LAYOUTS) + 1, H, HD)).astype(np.float32)
    q_bits = np.array([bam.text_token((1,)), bam.text_token(instance=1), 0],
                      np.int32)[:, None]
    q_pos = np.array([[19], [4], [0]], np.int32)
    rids = [0, 1, None]
    jg = j_build_grid(jt, rids, q_bits[:, 0].astype(np.uint32), q_pos[:, 0],
                      pad_to=16)
    tg = build_decode_grid(tt, rids, q_bits[:, 0], q_pos[:, 0], pad_to=16)
    return jt, tt, jg, tg, q, k, v, q_bits, q_pos


@functools.lru_cache(maxsize=None)
def _jax_out(H, Hkv, softcap, window):
    jt, _, jg, _, q, k, v, q_bits, q_pos = _fixture(H, Hkv)
    return np.asarray(j_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(q_bits.astype(np.uint32)), jnp.asarray(q_pos),
        jnp.asarray(jt.bits), jnp.asarray(jt.pos), jg.arrays(),
        softcap=softcap, window=window, interpret=True))


def _torch_args(H, Hkv):
    _, tt, _, tg, q, k, v, q_bits, q_pos = _fixture(H, Hkv)
    args = tuple(torch.from_numpy(a) for a in
                 (q, k, v, q_bits, q_pos, tt.bits, tt.pos))
    return args, decode_steps(tg.arrays(), q.shape[0], "cpu", kv_heads=Hkv,
                              page_size=PAGE_SIZE)


@pytest.mark.parametrize("pps", PPS)
@pytest.mark.parametrize("H,Hkv", GQA)
@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("window", [0, 4])
def test_split_combine_matches_plain_and_jax(pps, H, Hkv, softcap, window):
    args, steps = _torch_args(H, Hkv)
    steps = _with_pps(steps, pps)
    got, parts = k4_emulated(*args, steps, softcap=softcap, window=window)
    plain = paged_decode_torch(*args, steps, softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.numpy(),
                               _jax_out(H, Hkv, softcap, window), atol=ATOL)
    assert torch.isfinite(got).all()
    assert (got[2] == 0).all()                     # the empty row
    assert got[0].abs().sum() > 0
    # the wrapper on the CPU is the plain version, whatever the split
    wrapped = paged_decode_attention(*args, steps, softcap=softcap,
                                     window=window)
    assert torch.equal(wrapped, plain)
    assert paged_decode_attention.launches == 0


def test_split_with_no_allowed_key_gives_no_nan():
    """At window 4, one page per split: the early pages of both rows have
    no key in the window; their partials are exactly (-1e30, 0, 0), the
    merge weighs them by 0, and the empty row stays exactly 0."""
    args, steps = _torch_args(4, 2)
    steps = _with_pps(steps, 1)
    got, parts = k4_emulated(*args, steps, softcap=20.0, window=4)
    dead = [(m, l, acc) for _, m, l, acc in parts if (m == NEG_INF).all()]
    assert len(dead) >= 2
    for m, l, acc in dead:
        assert (l == 0).all() and (acc == 0).all()
    assert torch.isfinite(got).all()
    assert (got[2] == 0).all()
    plain = paged_decode_torch(*args, steps, softcap=20.0, window=4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)


def test_wrapper_refuses_steps_for_other_kv_heads():
    """Steps planned for another number of KV heads carry the wrong
    number of ticket counters: the wrapper raises, on the CPU too."""
    args, _ = _torch_args(4, 2)
    tg = _fixture(4, 2)[3]
    steps = decode_steps(tg.arrays(), 3, "cpu", kv_heads=4,
                         page_size=PAGE_SIZE)
    with pytest.raises(ValueError, match="KV head"):
        paged_decode_attention(*args, steps)


# ---------------------------------------------------------------------------
# bf16 at the kernel's widths
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _wide(H, Hkv, hd):
    """bf16 pool of rows of 300 (text), 130 (32 text, 64 modality-1, 34
    text; the query attends modality 1) and 17 tokens, and an empty row;
    page size 16, inputs from a numpy seed."""
    ps = 16
    layouts = [[("text", 0, 300)],
               [("text", 0, 32), ("mod", 1, 64), ("text", 0, 34)],
               [("text", 0, 17)]]
    P = 1 + sum(-(-sum(s[2] for s in segs) // ps) + 1 for segs in layouts)
    table = PageTable(P, ps)
    q_bits = [bam.text_token(), bam.text_token((1,)), bam.text_token(), 0]
    q_pos = []
    for rid, segs in enumerate(layouts):
        n = sum(s[2] for s in segs)
        bits, pos = bam.build_sample_bits(segs, n)
        table.alloc(rid, n + 1)
        table.write(rid, np.arange(n + 1), np.append(bits, q_bits[rid]),
                    np.append(pos, n))
        q_pos.append(n)
    q_pos.append(0)
    grid = build_decode_grid(table, [0, 1, 2, None], q_bits, q_pos)
    rng = np.random.default_rng(hd + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16() for shape in
        ((4, H, hd), (P, ps, Hkv, hd), (P, ps, Hkv, hd)))
    args = (q, k, v, torch.tensor(q_bits, dtype=torch.int32)[:, None],
            torch.tensor(q_pos, dtype=torch.int32)[:, None],
            torch.from_numpy(table.bits), torch.from_numpy(table.pos))
    return args, decode_steps(grid.arrays(), 4, "cpu", kv_heads=Hkv,
                              page_size=ps)


@pytest.mark.parametrize("pps", PPS)
@pytest.mark.parametrize("H,Hkv,hd", [(8, 2, 128), (8, 8, 64), (16, 2, 64)])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 64)])
def test_split_combine_keeps_bf16_ulp(pps, H, Hkv, hd, softcap, window):
    args, steps = _wide(H, Hkv, hd)
    steps = _with_pps(steps, pps)
    got, _ = k4_emulated(*args, steps, softcap=softcap, window=window)
    f32 = tuple(a.float() if a.is_floating_point() else a for a in args)
    plain = paged_decode_torch(*f32, steps, softcap=softcap, window=window)
    err, ratio = compare(got, plain, "bfloat16")
    assert ratio <= SPLIT_MAX, (err, ratio)
    assert (got[3] == 0).all()
