"""The port's plain K1 and K4 against the JAX package's Pallas kernels run
in interpret mode, on the same numpy inputs.

K1: ``bam_flash_attention(..., return_mode="residual")`` (out and lse)
over GQA x softcap x window, each case with four batch rows: causal,
multimodal, two packed documents and a padded row; T = 30 is not a block
multiple (the JAX kernel gets it padded with bits 0 / pos -1). K4:
``paged_decode_attention`` on tests/test_serving.py's LAYOUTS fixture,
where the empty row must be exactly 0, and ``build_decode_grid``'s
arrays must be equal. Tolerance 2e-5 (f32; only summation order
differs)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.bam_attention import bam_flash_attention as j_flash
from repro.kernels.paged_decode import paged_decode_attention as j_paged
from repro.kernels.paged_decode import paged_decode_ref as j_paged_ref
from repro.serving import PageTable as JPageTable
from repro.serving import build_decode_grid as j_build_grid
from repro_torch.core import bam as tbam
from repro_torch.kernels import ops as tops
from repro_torch.kernels.bam_attention import (NEG_INF, bam_bwd_dkv,
                                               bam_bwd_dq, bam_flash_attention,
                                               bam_flash_attention_torch)
from repro_torch.kernels.paged_decode import (decode_steps,
                                              paged_decode_attention,
                                              paged_decode_ref,
                                              paged_decode_torch)
from repro_torch.serving import PageTable, build_decode_grid
from tests.test_serving import LAYOUTS

ATOL = 2e-5
T, HD = 30, 16
ROWS = [
    [("text", 0, 30)],                                            # causal
    [("text", 0, 6), ("mod", 1, 12), ("text", 0, 12)],            # multimodal
    [("text", 0, 14), ("newdoc", 0, 0), ("text", 0, 16)],         # two docs
    [("text", 0, 20)],                                            # padded
]


def _bits():
    pairs = [tbam.build_sample_bits(segs, T) for segs in ROWS]
    return np.stack([b for b, _ in pairs]), np.stack([p for _, p in pairs])


def _qkv(H, Hkv, seed=0):
    rng = np.random.default_rng(seed)
    B = len(ROWS)
    return (rng.normal(size=(B, T, H, HD)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, HD)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, HD)).astype(np.float32))


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("window", [0, 4])
def test_k1_plain_matches_jax_kernel(H, Hkv, softcap, window):
    q, k, v = _qkv(H, Hkv)
    bits, pos = _bits()
    Tp, blk = 32, 16
    pad = ((0, 0), (0, Tp - T))
    jb = jnp.asarray(np.pad(bits, pad).astype(np.uint32))
    jp = jnp.asarray(np.pad(pos, pad, constant_values=-1))
    padt = ((0, 0), (0, Tp - T), (0, 0), (0, 0))
    j_out, j_lse = j_flash(
        jnp.asarray(np.pad(q, padt)), jnp.asarray(np.pad(k, padt)),
        jnp.asarray(np.pad(v, padt)), jb, jb, jp, jp, softcap=softcap,
        window=window, block_q=blk, block_k=blk, interpret=True,
        return_mode="residual")
    tb, tp = torch.from_numpy(bits), torch.from_numpy(pos)
    out, lse = bam_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tb, tb, tp, tp, softcap=softcap, window=window,
        return_mode="residual")
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out)[:, :T],
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, :T],
                               atol=ATOL, rtol=1e-6)
    # the padded row's pad queries: exact zeros and the -1e30 sentinel
    assert (out[3, 20:] == 0).all()
    assert (lse[3, :, 20:] == NEG_INF).all()


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (20.0, 4)])
def test_ops_bam_kernel_matches_jax_reference(softcap, window):
    """The port's op (unpadded T = 30, K1's plain version on the CPU)
    against the JAX op's reference path."""
    q, k, v = _qkv(8, 2, seed=1)
    bits, pos = _bits()
    want = jops.bam_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bits.astype(np.uint32)), jnp.asarray(bits.astype(np.uint32)),
        jnp.asarray(pos), jnp.asarray(pos), softcap=softcap, window=window,
        impl="xla")
    tb, tp = torch.from_numpy(bits), torch.from_numpy(pos)
    for impl in ("bam_kernel", "xla"):
        got = tops.bam_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tb, tb, tp, tp, softcap=softcap, window=window, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_ops_rejects_what_the_port_lacks():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2))
    bits, pos = (torch.from_numpy(a) for a in _bits())
    with pytest.raises(ValueError, match="bam_interpret"):
        tops.bam_attention(q, k, v, bits, bits, pos, pos,
                           impl="bam_interpret")
    with pytest.raises(ValueError, match="return_mode='lse'"):
        bam_flash_attention(q, k, v, bits, bits, pos, pos,
                            return_mode="lse")
    # the stats mode (context parallelism) runs: acc [B,H,T,hd], m, l
    acc, m, l = bam_flash_attention(q, k, v, bits, bits, pos, pos,
                                    return_mode="stats")
    assert acc.shape == (q.shape[0], q.shape[2], q.shape[1], q.shape[3])
    assert m.shape == l.shape == acc.shape[:3]
    assert bam_flash_attention.stats_launches == 0
    # the op has a backward now (tests/test_torch_bwd.py); on the CPU it
    # runs the plain versions of K1, K2 and K3 and never launches
    tops.bam_attention(q.requires_grad_(), k, v, bits, bits, pos, pos,
                       impl="bam_kernel").sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert bam_flash_attention.launches == 0          # the CPU never launches
    assert bam_bwd_dq.launches == 0 and bam_bwd_dkv.launches == 0


def _paged_fixture(page_size, Hkv, hd, seed=0):
    """The same pool in both packages, one request per LAYOUTS entry."""
    rng = np.random.default_rng(seed)
    total = 1 + sum(-(-sum(s[2] for s in segs) // page_size)
                    for segs in LAYOUTS)
    jt, tt = JPageTable(total + 2, page_size), PageTable(total + 2, page_size)
    for rid, segs in enumerate(LAYOUTS):
        n = sum(s[2] for s in segs)
        bits, pos = tbam.build_sample_bits(segs, n)
        for table in (jt, tt):
            table.alloc(rid, n)
            table.write(rid, np.arange(n), bits, pos)
    P = tt.num_pages
    k = rng.normal(size=(P, page_size, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(P, page_size, Hkv, hd)).astype(np.float32)
    return jt, tt, k, v


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("window", [0, 4])
def test_k4_plain_matches_jax_kernel(H, Hkv, softcap, window):
    page_size, hd = 8, 16
    jt, tt, k, v = _paged_fixture(page_size, Hkv, hd)
    rng = np.random.default_rng(1)
    B = len(LAYOUTS) + 1                       # + one empty row
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    q_bits = np.array([tbam.text_token((1,)), tbam.text_token(instance=1), 0],
                      np.int32)[:, None]
    q_pos = np.array([[19], [4], [0]], np.int32)
    rids = [0, 1, None]
    jg = j_build_grid(jt, rids, q_bits[:, 0].astype(np.uint32), q_pos[:, 0],
                      window=window, pad_to=16)
    tg = build_decode_grid(tt, rids, q_bits[:, 0], q_pos[:, 0],
                           window=window, pad_to=16)
    for a, b in zip(tg.arrays(), jg.arrays()):
        np.testing.assert_array_equal(a, b)
    assert tg.n_dense_steps == jg.n_dense_steps

    want = np.asarray(j_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(q_bits.astype(np.uint32)), jnp.asarray(q_pos),
        jnp.asarray(jt.bits), jnp.asarray(jt.pos), jg.arrays(),
        softcap=softcap, window=window, interpret=True))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(q_bits), torch.from_numpy(q_pos),
            torch.from_numpy(tt.bits), torch.from_numpy(tt.pos))
    got = paged_decode_attention(*args, tg.arrays(), softcap=softcap,
                                 window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert got[0].abs().sum() > 0
    assert (got[2] == 0).all()                 # empty row exactly 0
    assert paged_decode_attention.launches == 0

    # the dense-gather oracle, port against JAX
    mp = max(len(tt.pages_of(r)) for r in (0, 1))
    pt = np.stack([tt.page_table_row(r, mp) for r in (0, 1)]
                  + [np.zeros(mp, np.int32)])
    ref = paged_decode_ref(*args, torch.from_numpy(pt), softcap=softcap,
                           window=window)
    jref = j_paged_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(q_bits.astype(np.uint32)), jnp.asarray(q_pos),
        jnp.asarray(jt.bits), jnp.asarray(jt.pos), jnp.asarray(pt),
        softcap=softcap, window=window)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=ATOL)


def test_decode_steps_csr():
    """Active steps become CSR rows; flush and padding steps drop out."""
    steps = (np.array([0, 0, 1, 2, 2, 0, 0]), np.array([3, 4, 0, 5, 6, 0, 0]),
             np.array([1, 0, 1, 1, 0, 0, 0]), np.array([0, 1, 1, 0, 1, 0, 0]),
             np.array([1, 1, 0, 1, 1, 0, 0]))
    s = decode_steps(steps, 3, "cpu", kv_heads=2, page_size=8)
    assert s.row_ptr.tolist() == [0, 2, 2, 4]
    assert s.pages.tolist() == [3, 4, 5, 6]
    with pytest.raises(ValueError, match="grouped by row"):
        decode_steps((np.array([1, 0]), np.array([1, 2]), np.ones(2),
                      np.ones(2), np.ones(2)), 2, "cpu", kv_heads=2,
                     page_size=8)


def test_plain_k1_matches_dense_reference_bf16():
    """The plain versions keep the kernels' dtype contract: bf16 in,
    bf16 out, f32 lse, and agree with the dense oracle."""
    from repro_torch.kernels.ref import bam_attention_ref
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(4, 2))
    bits, pos = (torch.from_numpy(a) for a in _bits())
    out, lse = bam_flash_attention_torch(q, k, v, bits, bits, pos, pos,
                                         return_mode="residual")
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = bam_attention_ref(q, k, v, bits, bits, pos, pos)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=2 ** -6)
    steps = decode_steps((np.zeros(1), np.zeros(1), np.ones(1), np.ones(1),
                          np.zeros(1)), 1, "cpu", kv_heads=k.shape[2],
                         page_size=8)
    empty = paged_decode_torch(q[:1, 0], k[0, :8][None], v[0, :8][None],
                               bits[:1, :1], pos[:1, :1], bits[:1, :8],
                               pos[:1, :8], steps)
    assert (empty == 0).all()
