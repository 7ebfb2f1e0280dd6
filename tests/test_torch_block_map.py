"""The port's compacted-grid BAM attention (``block_map=``) against the
JAX package's, on the same numpy inputs, f32 on the CPU.

Maps are built by each package's ``build_block_map(..., 64, 32)``, the
port kernels' tile. The JAX side runs its Pallas kernels in interpret
mode with ``block_q=64, block_k=32, block_map=bm``; the port runs the
plain versions of K1 (three modes), K2 and K3 under the same map (what a
CPU tensor runs). Inputs: B = 1-2, H = 4, Hkv = 2, hd = 64, ragged T
(not block multiples), the ``ee`` and ``mp`` layouts of
``random_multimodal_bits``, with and without window 16.

Tolerances: outputs, lse and stats atol 1e-5 (f32; only the summation
order differs), the stats' unnormalised acc and l taken per row over the
JAX row's l (their scale, which reaches ~10 here; 1 where l = 0) and m as
it is; dq, dk, dv atol 1e-4, the reference's own backward tolerance
(tests/test_kernels.py).

Also: a pruned map (one active tile dropped from both lists) against the
JAX interpret path under the same map; fully padded q and k blocks give
exact zeros, lse = -1e30 and stats (-1e30, 0, 0); a map with another
tile, grid or window is refused; and the port's analogue of kernellint's
``check_block_map_coverage`` over its layouts: the CSR rows cover every
(64, 32) tile that holds an allowed pair, in both orders.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.analysis.kernellint import _COVERAGE_LAYOUTS
from repro.core import bam as jbam
from repro.kernels import ops as jops
from repro.kernels.bam_attention import bam_flash_attention as j_flash
from repro_torch.core import bam as tbam
from repro_torch.data.synthetic import random_multimodal_bits
from repro_torch.kernels import ops as tops
from repro_torch.kernels.bam_attention import (
    BLOCK_K, BLOCK_Q, NEG_INF, bam_bwd_dkv, bam_bwd_dq, bam_flash_attention,
    bam_flash_attention_bwd, bwd_delta)

OUT_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=1e-4, rtol=0)
H, HKV, HD = 4, 2, 64
# layout -> (T, seeds of the batch rows)
LAYOUTS = {"ee": (200, (0, 1)), "mp": (260, (0,))}


def _case(layout, seed=0):
    T, seeds = LAYOUTS[layout]
    rows = [random_multimodal_bits(T, layout, seed=s) for s in seeds]
    bits = np.stack([b for b, _ in rows])
    pos = np.stack([p for _, p in rows])
    rng = np.random.default_rng(seed)
    B = len(seeds)
    q, g = (rng.normal(size=(B, T, H, HD)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(B, T, HKV, HD)).astype(np.float32)
            for _ in range(2))
    return q, k, v, g, bits, pos


def _maps(bits, pos, window):
    """(port map, JAX map) from the same numpy bits at the port's tile."""
    tbm = tbam.build_block_map(bits, bits, pos, pos, BLOCK_Q, BLOCK_K,
                               window)
    jbm = jbam.build_block_map(bits.astype(np.uint32), bits.astype(np.uint32),
                               pos, pos, BLOCK_Q, BLOCK_K, window)
    assert tbm.q_steps == jbm.q_steps and tbm.k_steps == jbm.k_steps
    return tbm, jbm


def _as_jax_map(tbm):
    return jbam.BlockMask(**dataclasses.asdict(tbm))


def _pad(a, T, axis, value=0):
    cfg = [(0, 0)] * a.ndim
    cfg[axis] = (0, T - a.shape[axis])
    return np.pad(a, cfg, constant_values=value)


def _jax_flash(q, k, v, bits, pos, jbm, mode, softcap=0.0, window=0):
    """The JAX kernel in interpret mode on inputs padded to the map's
    grid (bits 0, positions -1, as the JAX op pads), cropped back."""
    T = q.shape[1]
    Tq, Tk = jbm.nq * BLOCK_Q, jbm.nk * BLOCK_K
    qb, qp = _pad(bits, Tq, 1), _pad(pos, Tq, 1, -1)
    kb, kp = _pad(bits, Tk, 1), _pad(pos, Tk, 1, -1)
    outs = j_flash(
        jnp.asarray(_pad(q, Tq, 1)), jnp.asarray(_pad(k, Tk, 1)),
        jnp.asarray(_pad(v, Tk, 1)), jnp.asarray(qb.astype(np.uint32)),
        jnp.asarray(kb.astype(np.uint32)), jnp.asarray(qp), jnp.asarray(kp),
        softcap=softcap, window=window, block_q=BLOCK_Q, block_k=BLOCK_K,
        interpret=True, return_mode=mode, block_map=jbm)
    if mode == "out":
        return [np.asarray(outs)[:, :T]]
    if mode == "residual":
        return [np.asarray(outs[0])[:, :T], np.asarray(outs[1])[:, :, :T]]
    acc = np.einsum("bqhd->bhqd", np.asarray(outs[0]))
    return [acc[:, :, :T], np.asarray(outs[1])[:, :, :T],
            np.asarray(outs[2])[:, :, :T]]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_grads(q, k, v, g, bits, pos, jbm, softcap, window):
    jb, jp = jnp.asarray(bits.astype(np.uint32)), jnp.asarray(pos)

    def loss(q, k, v):
        out = jops.bam_attention(q, k, v, jb, jb, jp, jp, softcap=softcap,
                                 window=window, impl="bam_interpret",
                                 block_q=BLOCK_Q, block_k=BLOCK_K,
                                 block_map=jbm)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _torch_grads(q, k, v, g, bits, pos, tbm, softcap, window, impl):
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    tb, tp = _t(bits, pos)
    out = tops.bam_attention(tq, tk, tv, tb, tb, tp, tp, softcap=softcap,
                             window=window, impl=impl, block_map=tbm)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach(), [tq.grad, tk.grad, tv.grad]


def _close(got, want, tol, what=""):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol,
                                   err_msg=f"{what} [{i}]")


def _close_stats(got, want):
    """(acc, m, l) against the JAX stats: acc and l over the JAX row's l,
    m as it is, atol 1e-5."""
    scale = np.maximum(want[2], 1.0)
    acc, m, l = (np.asarray(x) for x in got)
    _close([acc / scale[..., None], m, l / scale],
           [want[0] / scale[..., None], want[1], want[2] / scale], OUT_TOL,
           "stats (acc, m, l)")


# ---------------------------------------------------------------------------
# Forward (K1c in its three modes) and backward (K2c, K3c) against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("mode", ["out", "residual", "stats"])
def test_forward_matches_jax_interpret(layout, window, mode):
    q, k, v, _, bits, pos = _case(layout)
    tbm, jbm = _maps(bits, pos, window)
    assert tbm.n_steps < tbm.n_dense_steps            # a compacted grid
    want = _jax_flash(q, k, v, bits, pos, jbm, mode, window=window)
    tb, tp = _t(bits, pos)
    got = bam_flash_attention(*_t(q, k, v), tb, tb, tp, tp, window=window,
                              return_mode=mode, block_map=tbm)
    got = got if isinstance(got, tuple) else (got,)
    if mode == "stats":
        _close_stats([x.numpy() for x in got], want)
    else:
        _close([x.numpy() for x in got], want, OUT_TOL, mode)
    assert bam_flash_attention.compact_launches == 0  # the CPU never launches
    if mode == "stats":                               # the op's stats entry
        got_op = tops.bam_attention_stats(*_t(q, k, v), tb, tb, tp, tp,
                                          window=window, block_map=tbm)
        assert all(torch.equal(a, b) for a, b in zip(got, got_op))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (20.0, 16)])
def test_grads_match_jax_interpret(layout, softcap, window):
    """The op's ``block_map=`` path (BamAttention carries the map to K2c
    and K3c) against jax.grad through the JAX op in interpret mode."""
    q, k, v, g, bits, pos = _case(layout, seed=1)
    tbm, jbm = _maps(bits, pos, window)
    want_out, want = _jax_grads(q, k, v, g, bits, pos, jbm, softcap, window)
    out, got = _torch_grads(q, k, v, g, bits, pos, tbm, softcap, window,
                            "bam_kernel")
    _close([out.numpy()], [want_out], OUT_TOL, "out")
    _close([x.numpy() for x in got], want, GRAD_TOL, "dq, dk, dv")
    assert bam_bwd_dq.compact_launches == bam_bwd_dkv.compact_launches == 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_covering_map_equals_no_map(layout):
    """A map built from the mask covers it, so with or without it the
    plain path gives the same bits, forward and backward."""
    q, k, v, g, bits, pos = _case(layout, seed=2)
    tbm, _ = _maps(bits, pos, 16)
    with_map = _torch_grads(q, k, v, g, bits, pos, tbm, 0.0, 16,
                            "bam_kernel")
    without = _torch_grads(q, k, v, g, bits, pos, None, 0.0, 16,
                           "bam_kernel")
    assert torch.equal(with_map[0], without[0])
    assert all(torch.equal(a, b) for a, b in zip(with_map[1], without[1]))


# ---------------------------------------------------------------------------
# A pruned map: the step list is what is walked
# ---------------------------------------------------------------------------

def _pruned(tbm, bits, pos, window):
    """``tbm`` without the first active tile of its middle q block that
    holds an allowed pair."""
    mask = tbam.allowed_mask_np(bits, bits, pos, pos, window).any(0)
    active = tbm.active_tiles()
    iq = tbm.nq // 2
    rows = mask[iq * BLOCK_Q:(iq + 1) * BLOCK_Q]
    ik = next(j for j in np.flatnonzero(active[iq])
              if rows[:, j * BLOCK_K:(j + 1) * BLOCK_K].any())
    active[iq, ik] = False
    return tbam.block_map_from_tiles(active, BLOCK_Q, BLOCK_K, window)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("window", [0, 16])
def test_pruned_map_matches_jax_interpret(layout, window):
    q, k, v, g, bits, pos = _case(layout, seed=3)
    tbm, _ = _maps(bits, pos, window)
    pruned = _pruned(tbm, bits, pos, window)
    jpruned = _as_jax_map(pruned)
    assert pruned.active_tiles().sum() == tbm.active_tiles().sum() - 1
    # forward in every mode
    tb, tp = _t(bits, pos)
    want = _jax_flash(q, k, v, bits, pos, jpruned, "residual", window=window)
    got = bam_flash_attention(*_t(q, k, v), tb, tb, tp, tp, window=window,
                              return_mode="residual", block_map=pruned)
    _close([x.numpy() for x in got], want, OUT_TOL, "residual")
    want = _jax_flash(q, k, v, bits, pos, jpruned, "stats", window=window)
    got = bam_flash_attention(*_t(q, k, v), tb, tb, tp, tp, window=window,
                              return_mode="stats", block_map=pruned)
    _close_stats([x.numpy() for x in got], want)
    # the op, forward and backward
    want_out, want = _jax_grads(q, k, v, g, bits, pos, jpruned, 0.0, window)
    out, got = _torch_grads(q, k, v, g, bits, pos, pruned, 0.0, window,
                            "bam_kernel")
    _close([out.numpy()], [want_out], OUT_TOL, "out")
    _close([x.numpy() for x in got], want, GRAD_TOL, "dq, dk, dv")
    # it differs from the full map's result, and impl="xla" under the
    # same map gives the kernel path's answer
    full, _ = _torch_grads(q, k, v, g, bits, pos, tbm, 0.0, window,
                           "bam_kernel")
    assert not torch.equal(out, full)
    out_x, got_x = _torch_grads(q, k, v, g, bits, pos, pruned, 0.0, window,
                                "xla")
    _close([out_x.numpy()], [out.numpy()], OUT_TOL, "xla out")
    _close([x.numpy() for x in got_x], [x.numpy() for x in got], GRAD_TOL,
           "xla grads")


def test_pruned_plain_kernels_take_their_own_list():
    """K2's plain version walks the q-major list and K3's the k-major
    list: a tile dropped from the k-major list alone changes dK/dV only."""
    q, k, v, g, bits, pos = _case("mp", seed=4)
    tbm, _ = _maps(bits, pos, 0)
    pruned = _pruned(tbm, bits, pos, 0)
    k_only = dataclasses.replace(tbm, k_steps=pruned.k_steps)
    tq, tk, tv, tg, tb, tp = _t(q, k, v, g, bits, pos)
    out, lse = bam_flash_attention(tq, tk, tv, tb, tb, tp, tp,
                                   return_mode="residual", block_map=tbm)
    args = (tq, tk, tv, tg, lse, bwd_delta(out, tg), tb, tb, tp, tp)
    assert torch.equal(bam_bwd_dq(*args, block_map=k_only),
                       bam_bwd_dq(*args, block_map=tbm))
    dk, dv = bam_bwd_dkv(*args, block_map=k_only)
    dk_full, dv_full = bam_bwd_dkv(*args, block_map=tbm)
    assert not torch.equal(dk, dk_full) and not torch.equal(dv, dv_full)
    _close([dk.numpy(), dv.numpy()],
           [x.numpy() for x in bam_bwd_dkv(*args, block_map=pruned)],
           dict(atol=0, rtol=0))


# ---------------------------------------------------------------------------
# Fully padded q and k blocks
# ---------------------------------------------------------------------------

def test_padded_blocks_are_exact_zeros():
    """T = 230 with 120 real tokens per row: q blocks 2-3 and k blocks
    4-7 hold padding only, so their CSR rows are empty. Out, dq, dk and dv
    are exactly 0 there, lse = -1e30 and stats (-1e30, 0, 0), as in the
    JAX interpret path."""
    T, n = 230, 120
    rows = [tbam.build_sample_bits([("text", 0, 40), ("mod", 1, 50),
                                    ("text", 0, 30)], T),
            tbam.build_sample_bits([("text", 0, n)], T)]
    bits = np.stack([b for b, _ in rows])
    pos = np.stack([p for _, p in rows])
    rng = np.random.default_rng(5)
    q, g = (rng.normal(size=(2, T, H, HD)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(2, T, HKV, HD)).astype(np.float32)
            for _ in range(2))
    tbm, jbm = _maps(bits, pos, 0)
    csr = tbam.block_csr(tbm, "cpu")
    q_rows = np.diff(csr.q_ptr.numpy())
    k_rows = np.diff(csr.k_ptr.numpy())
    assert (q_rows[2:] == 0).all() and (q_rows[:2] > 0).all()
    assert (k_rows[4:] == 0).all() and (k_rows[:4] > 0).all()
    tb, tp = _t(bits, pos)
    out, lse = bam_flash_attention(*_t(q, k, v), tb, tb, tp, tp,
                                   return_mode="residual", block_map=tbm)
    acc, m, l = bam_flash_attention(*_t(q, k, v), tb, tb, tp, tp,
                                    return_mode="stats", block_map=tbm)
    pad_q = slice(2 * BLOCK_Q, T)
    assert (out[:, pad_q] == 0).all() and (lse[:, :, pad_q] == NEG_INF).all()
    assert (acc[:, :, pad_q] == 0).all() and (l[:, :, pad_q] == 0).all()
    assert (m[:, :, pad_q] == NEG_INF).all()
    _close([out.numpy(), lse.numpy()],
           _jax_flash(q, k, v, bits, pos, jbm, "residual"), OUT_TOL)
    _close_stats([acc.numpy(), m.numpy(), l.numpy()],
                 _jax_flash(q, k, v, bits, pos, jbm, "stats"))
    out_g, grads = _torch_grads(q, k, v, g, bits, pos, tbm, 0.0, 0,
                                "bam_kernel")
    pad_k = slice(4 * BLOCK_K, T)
    assert (grads[0][:, pad_q] == 0).all()
    assert (grads[1][:, pad_k] == 0).all() and (grads[2][:, pad_k] == 0).all()
    _, want = _jax_grads(q, k, v, g, bits, pos, jbm, 0.0, 0)
    _close([x.numpy() for x in grads], want, GRAD_TOL, "dq, dk, dv")


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_block_map_refusals():
    """A map built for another tile, grid or window is refused by every
    entry point (the reference's _check_block_map asserts the same)."""
    q, k, v, g, bits, pos = _case("ee")
    T = q.shape[1]
    tq, tk, tv, tg, tb, tp = _t(q, k, v, g, bits, pos)
    wrong = {
        "tile": tbam.build_block_map(bits, bits, pos, pos, 64, 64),
        "grid": tbam.build_block_map(bits[:, :T - 70], bits[:, :T - 70],
                                     pos[:, :T - 70], pos[:, :T - 70],
                                     BLOCK_Q, BLOCK_K),
        "window": tbam.build_block_map(bits, bits, pos, pos, BLOCK_Q,
                                       BLOCK_K, window=8),
    }
    lse = torch.zeros(q.shape[0], H, T)
    for what, bm in wrong.items():
        for mode in ("out", "residual", "stats"):
            with pytest.raises(ValueError, match=what):
                bam_flash_attention(tq, tk, tv, tb, tb, tp, tp,
                                    return_mode=mode, block_map=bm)
        for fn in (bam_bwd_dq, bam_bwd_dkv):
            with pytest.raises(ValueError, match=what):
                fn(tq, tk, tv, tg, lse, lse, tb, tb, tp, tp, block_map=bm)
        with pytest.raises(ValueError, match=what):
            bam_flash_attention_bwd(tq, tk, tv, tq, tg, lse, tb, tb, tp, tp,
                                    block_map=bm)
        for impl in ("bam_kernel", "xla"):
            with pytest.raises(ValueError, match=what):
                tops.bam_attention(tq, tk, tv, tb, tb, tp, tp, impl=impl,
                                   block_map=bm)
        with pytest.raises(ValueError, match=what):
            tops.bam_attention_stats(tq, tk, tv, tb, tb, tp, tp,
                                     block_map=bm)
    out_of_grid = dataclasses.replace(
        wrong["window"], window=0,
        q_steps=wrong["window"].q_steps + ((0, 99, 1, 1, 1),))
    with pytest.raises(ValueError, match="outside"):
        bam_flash_attention(tq, tk, tv, tb, tb, tp, tp,
                            block_map=out_of_grid)


# ---------------------------------------------------------------------------
# The CSR arrays: coverage (kernellint's rule at the port's tile), cache
# ---------------------------------------------------------------------------

def _needed_tiles(bits, pos, window):
    mask = tbam.allowed_mask_np(bits[None], bits[None], pos[None],
                                pos[None], window)[0]
    qs, ks = np.nonzero(mask)
    return {(int(a) // BLOCK_Q, int(b) // BLOCK_K) for a, b in zip(qs, ks)}


def _csr_tiles(ptr, idx, transpose=False):
    ptr, idx = ptr.numpy(), idx.numpy()
    tiles = []
    for row in range(len(ptr) - 1):
        cols = idx[ptr[row]:ptr[row + 1]]
        assert (np.diff(cols) > 0).all(), "a CSR row is not ascending"
        tiles += [(int(c), row) if transpose else (row, int(c))
                  for c in cols]
    return set(tiles)


@pytest.mark.parametrize("li", range(len(_COVERAGE_LAYOUTS)))
@pytest.mark.parametrize("scale", [1, 16, 23])
@pytest.mark.parametrize("window", [0, 3])
def test_csr_covers_every_allowed_tile(li, scale, window):
    """kernellint's ``check_block_map_coverage`` layouts, each segment
    ``scale`` times longer (so the 64 x 32 tiles split them; 23 gives
    ragged lengths), window ``window * scale``: the q-major and k-major
    CSR rows hold exactly the tiles with an allowed pair, each row
    ascending, and the JAX map at the same tile has the same steps."""
    segs = [(kind, m, n * scale) for kind, m, n in _COVERAGE_LAYOUTS[li]]
    T = 14 * scale
    window *= scale
    bits, pos = tbam.build_sample_bits(segs, T)
    tbm = tbam.build_block_map(bits, bits, pos, pos, BLOCK_Q, BLOCK_K,
                               window)
    jbm = jbam.build_block_map(bits.astype(np.uint32), bits.astype(np.uint32),
                               pos, pos, BLOCK_Q, BLOCK_K, window)
    assert tbm.q_steps == jbm.q_steps and tbm.k_steps == jbm.k_steps
    csr = tbam.block_csr(tbm, "cpu")
    for x in csr:
        assert x.dtype == torch.int32 and x.is_contiguous()
    assert csr.q_ptr.numel() == tbm.nq + 1 and csr.k_ptr.numel() == tbm.nk + 1
    needed = _needed_tiles(bits, pos, window)
    assert needed
    assert _csr_tiles(csr.q_ptr, csr.q_cols) == needed
    assert _csr_tiles(csr.k_ptr, csr.k_rows, transpose=True) == needed
    # the plain versions' tile mask keeps every allowed pair
    mask = tbam.allowed_mask(*_t(bits[None], bits[None], pos[None],
                                 pos[None]), window)[0]
    for major in ("q", "k"):
        tiles = tbam.tile_mask(tbm, T, T, "cpu", major)
        assert tiles.shape == (T, T) and not (mask & ~tiles).any()


def test_csr_is_uploaded_once_per_map_and_device():
    bits, pos = random_multimodal_bits(300, "ee", seed=0)
    a = tbam.build_block_map(bits, bits, pos, pos, BLOCK_Q, BLOCK_K)
    b = tbam.build_block_map(bits, bits, pos, pos, BLOCK_Q, BLOCK_K)
    assert a == b and hash(a) == hash(b)
    assert tbam.block_csr(a, "cpu") is tbam.block_csr(b, "cpu")
    assert tbam.block_csr(a, "cpu") is not tbam.block_csr(
        tbam.build_block_map(bits, bits, pos, pos, BLOCK_Q, BLOCK_K, 8),
        "cpu")


@pytest.mark.parametrize("mode", ["ep", "ee", "mp"])
def test_smoke_layout_maps_match_jax(mode):
    """The layouts chip_smoke.py times (T = 4096, seed 0): the port's map
    at the kernels' tile equals the JAX package's."""
    bits, pos = random_multimodal_bits(4096, mode, seed=0)
    tbm, jbm = _maps(bits[None], pos[None], 0)
    assert (tbm.nq, tbm.nk) == (64, 128)
    assert tbm.skip_fraction == jbm.skip_fraction
