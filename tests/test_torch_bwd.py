"""The port's BAM attention backward against the JAX package's, on the
same numpy inputs, f32 on the CPU.

- The port's op ``bam_attention(impl="bam_kernel")`` (the
  ``autograd.Function``: K1 forward, K2/K3 backward, all as their plain
  versions on the CPU) against ``jax.grad`` through the JAX op with
  ``impl="bam_interpret"`` (the Pallas kernels interpreted), over GQA x
  softcap x window. Each case has four batch rows: causal, multimodal,
  two packed documents, and a row padded with bits 0, whose queries have
  no allowed key. T = 30 is not a block multiple (the JAX op pads it).
- ``bam_flash_attention_bwd_torch`` and the K2/K3 wrappers against
  ``bam_flash_attention_bwd(interpret=True)`` from the same (out, lse).
- The dense oracle's autograd gradient against ``jax.grad`` of the JAX
  oracle.
- The Function saves no [Tq, Tk] tensor; empty rows get exactly zero
  gradients; a non-CPU, non-CUDA tensor is refused rather than run.

Tolerance: f32 atol 1e-5 (only the summation order differs).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bam_attention import bam_flash_attention as j_flash
from repro.kernels.bam_attention import bam_flash_attention_bwd as j_bwd
from repro_torch.core import bam as tbam
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bam_attention import (
    bam_bwd_dkv, bam_bwd_dkv_torch, bam_bwd_dq, bam_bwd_dq_torch,
    bam_flash_attention_bwd, bam_flash_attention_bwd_torch, bwd_delta)

TOL = dict(atol=1e-5, rtol=0)
T, HD = 30, 16
ROWS = [
    [("text", 0, 30)],                                            # causal
    [("text", 0, 6), ("mod", 1, 12), ("text", 0, 12)],            # multimodal
    [("text", 0, 14), ("newdoc", 0, 0), ("text", 0, 16)],         # two docs
    [("text", 0, 20)],                                            # padded
]
GQA = [(4, 4), (4, 2), (8, 2)]
CAP_WIN = [(0.0, 0), (20.0, 0), (0.0, 4), (20.0, 4)]


def _inputs(H, Hkv, seed=0):
    rng = np.random.default_rng(seed)
    B = len(ROWS)
    pairs = [tbam.build_sample_bits(segs, T) for segs in ROWS]
    bits = np.stack([b for b, _ in pairs])
    pos = np.stack([p for _, p in pairs])
    return (rng.normal(size=(B, T, H, HD)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, HD)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, HD)).astype(np.float32),
            rng.normal(size=(B, T, H, HD)).astype(np.float32),   # cotangent
            bits, pos)


def _jax_grads(fn, q, k, v, g):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * g)
    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))


def _torch_grads(fn, q, k, v, g):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (fn(q, k, v) * torch.from_numpy(g)).sum().backward()
    return q.grad, k.grad, v.grad


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("H,Hkv", GQA)
@pytest.mark.parametrize("softcap,window", CAP_WIN)
def test_op_grads_match_jax_kernel_grads(H, Hkv, softcap, window):
    q, k, v, g, bits, pos = _inputs(H, Hkv)
    jb, jp = jnp.asarray(bits.astype(np.uint32)), jnp.asarray(pos)
    want = _jax_grads(lambda q, k, v: jops.bam_attention(
        q, k, v, jb, jb, jp, jp, softcap=softcap, window=window,
        impl="bam_interpret", block_q=16, block_k=16), q, k, v, g)
    tb, tp = torch.from_numpy(bits), torch.from_numpy(pos)
    got = _torch_grads(lambda q, k, v: tops.bam_attention(
        q, k, v, tb, tb, tp, tp, softcap=softcap, window=window,
        impl="bam_kernel"), q, k, v, g)
    _close(got, want)
    # the padded row's pad tokens: no allowed pair, exactly zero grads
    for grad in got:
        assert (grad[3, 20:] == 0).all()


@pytest.mark.parametrize("H,Hkv", GQA)
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (20.0, 4)])
def test_bwd_pair_matches_jax_bwd(H, Hkv, softcap, window):
    """From the same (q, k, v, out, dO, lse): the plain pair, and the K2
    and K3 wrappers (plain on the CPU), against the JAX dQ and dK/dV
    kernels in interpret mode (inputs padded to 32 for them)."""
    q, k, v, do, bits, pos = _inputs(H, Hkv, seed=1)
    Tp = 32
    pad4 = ((0, 0), (0, Tp - T), (0, 0), (0, 0))
    pad2 = ((0, 0), (0, Tp - T))
    jq, jk, jv, jdo = (jnp.asarray(np.pad(a, pad4)) for a in (q, k, v, do))
    jb = jnp.asarray(np.pad(bits, pad2).astype(np.uint32))
    jp = jnp.asarray(np.pad(pos, pad2, constant_values=-1))
    out, lse = j_flash(jq, jk, jv, jb, jb, jp, jp, softcap=softcap,
                       window=window, block_q=16, block_k=16,
                       interpret=True, return_mode="residual")
    want = j_bwd(jq, jk, jv, out, jdo, lse, jb, jb, jp, jp, softcap=softcap,
                 window=window, block_q=16, block_k=16, interpret=True)
    want = [np.asarray(w)[:, :T] for w in want]
    out_t = torch.from_numpy(np.asarray(out)[:, :T].copy())
    lse_t = torch.from_numpy(np.asarray(lse)[:, :, :T].copy())
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tb, tp = torch.from_numpy(bits), torch.from_numpy(pos)
    kw = dict(softcap=softcap, window=window)
    _close(bam_flash_attention_bwd_torch(tq, tk, tv, out_t, tdo, lse_t, tb,
                                         tb, tp, tp, **kw), want)
    _close(bam_flash_attention_bwd(tq, tk, tv, out_t, tdo, lse_t, tb, tb,
                                   tp, tp, **kw), want)
    delta = bwd_delta(out_t, tdo)
    args = (tq, tk, tv, tdo, lse_t, delta, tb, tb, tp, tp)
    _close([bam_bwd_dq(*args, **kw), *bam_bwd_dkv(*args, **kw)], want)
    _close([bam_bwd_dq_torch(*args, **kw), *bam_bwd_dkv_torch(*args, **kw)],
           want)
    assert bam_bwd_dq.launches == 0 and bam_bwd_dkv.launches == 0


@pytest.mark.parametrize("H,Hkv", GQA)
@pytest.mark.parametrize("softcap,window", CAP_WIN)
def test_ref_grads_match_jax_grad(H, Hkv, softcap, window):
    """The dense oracle (and the op's impl="xla", which is the oracle)
    under autograd, against jax.grad of the JAX oracle; the padded row
    has queries with no allowed key."""
    q, k, v, g, bits, pos = _inputs(H, Hkv, seed=2)
    jb, jp = jnp.asarray(bits.astype(np.uint32)), jnp.asarray(pos)
    want = _jax_grads(lambda q, k, v: jref.bam_attention_ref(
        q, k, v, jb, jb, jp, jp, softcap=softcap, window=window), q, k, v, g)
    tb, tp = torch.from_numpy(bits), torch.from_numpy(pos)
    for fn in (tref.bam_attention_ref, lambda *a, **kw: tops.bam_attention(
            *a, **kw, impl="xla")):
        got = _torch_grads(lambda q, k, v: fn(
            q, k, v, tb, tb, tp, tp, softcap=softcap, window=window),
            q, k, v, g)
        _close(got, want)
        assert all(torch.isfinite(x).all() for x in got)


def test_backward_saves_no_quadratic_tensor():
    """The port's twin of the JAX package's no-O(Tq·Tk)-intermediate
    check: nothing the Function saves for backward has a [Tq, Tk] pair
    of axes, while the dense oracle's autograd does (so the hook sees
    what it should)."""
    Tq = Tk = 48
    q, k, v, g, _, _ = _inputs(4, 2)
    q = np.concatenate([q, q[:, :Tq - T]], 1)
    k = np.concatenate([k, k[:, :Tk - T]], 1)
    v = np.concatenate([v, v[:, :Tk - T]], 1)
    bits_np, pos_np = tbam.build_sample_bits(
        [("text", 0, 16), ("mod", 1, 16), ("text", 0, 16)], Tq)
    bits = torch.from_numpy(np.tile(bits_np, (4, 1)))
    pos = torch.from_numpy(np.tile(pos_np, (4, 1)))

    def saved_shapes(impl):
        shapes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
            tq, tk, tv = (torch.from_numpy(a).requires_grad_()
                          for a in (q, k, v))
            out = tops.bam_attention(tq, tk, tv, bits, bits, pos, pos,
                                     impl=impl)
        out.sum().backward()
        assert tq.grad is not None
        return shapes

    def quadratic(shape):
        return list(shape).count(Tq) >= 2

    shapes = saved_shapes("bam_kernel")
    assert shapes and not any(quadratic(s) for s in shapes), shapes
    assert any(quadratic(s) for s in saved_shapes("xla"))


def test_empty_rows_and_extreme_lse_give_zero_not_nan():
    """Rows with lse = -1e30 (no allowed key) and keys with bits 0: the
    plain K2/K3 select P = 0 (exp(s + 1e30) overflows, so multiplying by
    the mask would give NaN) and return exact zeros there."""
    q, k, v, do, bits, pos = _inputs(4, 2, seed=3)
    tq, tk, tv, tdo = (torch.from_numpy(a) * 50 for a in (q, k, v, do))
    tb, tp = torch.from_numpy(bits), torch.from_numpy(pos)
    out, lse = tops.bam_flash_attention(tq, tk, tv, tb, tb, tp, tp,
                                        return_mode="residual")
    assert (lse[3, :, 20:] == tref.NEG_INF).all()
    dq, dk, dv = bam_flash_attention_bwd(tq, tk, tv, out, tdo, lse, tb, tb,
                                         tp, tp)
    for grad in (dq, dk, dv):
        assert torch.isfinite(grad).all()
        assert (grad[3, 20:] == 0).all()


def test_bwd_wrappers_refuse_what_they_cannot_launch():
    q, k, v, do, bits, pos = (torch.from_numpy(a)
                              for a in _inputs(4, 2))
    lse = torch.zeros(4, 4, T)
    args = [q, k, v, do, lse, lse, bits, bits, pos, pos]
    with pytest.raises(ValueError, match="lse/delta"):
        bam_bwd_dq(*args[:4], lse[:, :, :5], *args[5:])
    with pytest.raises(ValueError, match="do"):
        bam_bwd_dkv(q, k, v, do[:, :5], *args[4:])
    meta = [a.to("meta") for a in args]
    for fn in (bam_bwd_dq, bam_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*meta)
    assert bam_bwd_dq.launches == 0 and bam_bwd_dkv.launches == 0
