"""Head sizes 80 and 256 in K1-K3 and 256 in K4, on the CPU, against the
JAX package on the same numpy inputs (f32, TF32 off).

On the card these head sizes run K1, K2 and K3 on their wgmma bodies
in bf16 (hd 80 padded to 128 in shared memory) and f32 on the SIMT
bodies, which ``chip_smoke.py`` holds against the plain versions tested
here:

- the plain K1 (``residual`` and ``stats``) at hd 80 and 256 against the
  Pallas kernel in interpret mode;
- K2 and K3 through the op's gradients (``impl="bam_kernel"``) against
  ``jax.grad`` through the JAX op in interpret mode;
- K4's plain version at hd 256 against the Pallas decode kernel in
  interpret mode on ``tests/test_serving.py``'s LAYOUTS;
- the wrappers' head-size rule (``kernel_body``, ``k4_caps``; the
  wrappers' refusals on CUDA tensors are ``chip_smoke.py``'s);
- reduced gemma2 at head_dim 256: the all-local variant's forward and
  one AdamW step on ``bam_kernel`` against JAX's ``bam_interpret``, and
  the alternating model through the port's serving engine (K4's plain
  version) against the JAX engine.

Tolerances: kernel level atol 2e-5 (only the summation order differs);
the forward within 1e-4 (``test_torch_dense_family``'s rule); the step's
loss and grad_norm within 1e-5 relative and its parameters within 1e-5
of max |parameter| (``test_torch_hybrid``'s rule, AdamW eps 1e-3); the
engines' greedy tokens identical (``test_torch_serving``'s rule).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.kernels import ops as jops
from repro.kernels.bam_attention import bam_flash_attention as j_flash
from repro.kernels.paged_decode import paged_decode_attention as j_paged
from repro.models import api as japi
from repro.optim import optimizer as jopt
from repro.serving import PageTable as JPageTable
from repro.serving import ServingEngine as JServingEngine
from repro.serving import build_decode_grid as j_build_grid
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.core import bam
from repro_torch.kernels import ops as tops
from repro_torch.kernels.bam_attention import (HEAD_DIMS, bam_bwd_dkv,
                                               bam_bwd_dq,
                                               bam_flash_attention,
                                               kernel_body)
from repro_torch.kernels.paged_decode import (k4_caps,
                                              paged_decode_attention)
from repro_torch.models import api
from repro_torch.optim import optimizer as opt
from repro_torch.serving import PageTable, ServingEngine, build_decode_grid
from repro_torch.training import steps

from .test_serving import LAYOUTS
from .test_torch_hybrid import _close_params

ATOL = 2e-5
REL = 1e-5
T = 32
ROWS = [[("text", 0, 32)],                                       # causal
        [("text", 0, 5), ("mod", 1, 13), ("text", 0, 14)]]       # multimodal
# (head_dim, softcap, window): zamba2's shared block, gemma2's local layers
CASES = [(80, 0.0, 0), (256, 50.0, 16)]
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=5, eps=1e-3)


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _inputs(hd, H=2, Hkv=1, seed=0):
    rng = np.random.default_rng(seed)
    pairs = [bam.build_sample_bits(segs, T) for segs in ROWS]
    bits = np.stack([b for b, _ in pairs])
    pos = np.stack([p for _, p in pairs])
    B = len(ROWS)
    draw = [rng.normal(size=(B, T, h, hd)).astype(np.float32)
            for h in (H, Hkv, Hkv, H)]
    return (*draw, bits, pos)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,softcap,window", CASES)
def test_k1_plain_matches_jax_kernel(hd, softcap, window):
    """K1 ``residual`` and ``stats`` (the wrapper's plain version on CPU
    tensors) against the Pallas kernel in interpret mode."""
    q, k, v, _, bits, pos = _inputs(hd)
    jb, jp = jnp.asarray(bits.astype(np.uint32)), jnp.asarray(pos)
    kw = dict(softcap=softcap, window=window)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, jb, jp, jp)
    targs = (*(torch.from_numpy(a) for a in (q, k, v, bits, bits, pos, pos)),)
    j_out, j_lse = j_flash(*jargs, block_q=32, block_k=32, interpret=True,
                           return_mode="residual", **kw)
    out, lse = bam_flash_attention(*targs, return_mode="residual", **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=ATOL,
                               rtol=1e-6)
    j_acc, j_m, j_l = j_flash(*jargs, block_q=32, block_k=32, interpret=True,
                              return_mode="stats", **kw)
    acc, m, l = bam_flash_attention(*targs, return_mode="stats", **kw)
    # the port writes acc [B,H,Tq,hd], the Pallas kernel [B,Tq,H,hd]
    np.testing.assert_allclose(acc.numpy(),
                               np.asarray(j_acc).transpose(0, 2, 1, 3),
                               atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(j_m), atol=ATOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(j_l), atol=ATOL,
                               rtol=1e-6)
    assert bam_flash_attention.launches == 0


@pytest.mark.parametrize("hd,softcap,window", CASES)
def test_k2_k3_through_the_op_match_jax_grad(hd, softcap, window):
    """The op's backward (K2 and K3 as their plain versions) against
    ``jax.grad`` through the JAX op with the Pallas kernels
    interpreted."""
    q, k, v, g, bits, pos = _inputs(hd, seed=1)
    jb, jp = jnp.asarray(bits.astype(np.uint32)), jnp.asarray(pos)
    kw = dict(softcap=softcap, window=window)

    def jloss(q, k, v):
        out = jops.bam_attention(q, k, v, jb, jb, jp, jp,
                                 impl="bam_interpret", block_q=32,
                                 block_k=32, **kw)
        return jnp.sum(out * g)
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tb, tp = torch.from_numpy(bits), torch.from_numpy(pos)
    out = tops.bam_attention(tq, tk, tv, tb, tb, tp, tp, impl="bam_kernel",
                             **kw)
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL)
    assert bam_bwd_dq.launches == 0 and bam_bwd_dkv.launches == 0


@pytest.mark.parametrize("softcap,window", [(50.0, 0), (50.0, 4)])
def test_k4_plain_matches_jax_kernel_at_256(softcap, window):
    """K4 at head_dim 256 (GQA 2:1) on LAYOUTS' pool with an empty row:
    the wrapper's plain version against the Pallas kernel in interpret
    mode; the empty row exactly 0."""
    page_size, H, Hkv, hd = 8, 4, 2, 256
    rng = np.random.default_rng(2)
    total = 1 + sum(-(-sum(s[2] for s in segs) // page_size)
                    for segs in LAYOUTS)
    jt, tt = JPageTable(total + 2, page_size), PageTable(total + 2, page_size)
    for rid, segs in enumerate(LAYOUTS):
        n = sum(s[2] for s in segs)
        b, p = bam.build_sample_bits(segs, n)
        for table in (jt, tt):
            table.alloc(rid, n)
            table.write(rid, np.arange(n), b, p)
    P = tt.num_pages
    k = rng.normal(size=(P, page_size, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(P, page_size, Hkv, hd)).astype(np.float32)
    B = len(LAYOUTS) + 1
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    q_bits = np.array([bam.text_token((1,)), bam.text_token(instance=1), 0],
                      np.int32)[:, None]
    q_pos = np.array([[19], [4], [0]], np.int32)
    rids = [0, 1, None]
    jg = j_build_grid(jt, rids, q_bits[:, 0].astype(np.uint32), q_pos[:, 0],
                      window=window, pad_to=16)
    tg = build_decode_grid(tt, rids, q_bits[:, 0], q_pos[:, 0],
                           window=window, pad_to=16)
    want = np.asarray(j_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(q_bits.astype(np.uint32)), jnp.asarray(q_pos),
        jnp.asarray(jt.bits), jnp.asarray(jt.pos), jg.arrays(),
        softcap=softcap, window=window, interpret=True))
    got = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_bits), torch.from_numpy(q_pos),
        torch.from_numpy(tt.bits), torch.from_numpy(tt.pos), tg.arrays(),
        softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert got[0].abs().sum() > 0 and (got[2] == 0).all()
    assert paged_decode_attention.launches == 0


# ---------------------------------------------------------------------------
# The wrappers' head-size rule
# ---------------------------------------------------------------------------

def test_head_size_rule():
    """K1-K3 take 64, 80, 128 and 256: bf16 runs every kernel on its
    wgmma body at every size, f32 on its SIMT body. K4 takes 64, 128 and
    256, with smaller caps at 256; 96 is refused by both rules."""
    assert HEAD_DIMS == (64, 80, 128, 256)
    for hd in HEAD_DIMS:
        for kernel in ("K1", "K2", "K3"):
            assert kernel_body(hd, torch.float32, kernel) == "simt"
            assert kernel_body(hd, torch.bfloat16, kernel) == "wgmma"
    for kernel in ("K1", "K2", "K3"):
        with pytest.raises(ValueError, match="head_dim 96"):
            kernel_body(96, torch.bfloat16, kernel)
    assert k4_caps(64) == k4_caps(128) == (64, 32)
    assert k4_caps(256) == (32, 16)
    for hd in (80, 96):
        with pytest.raises(ValueError, match=f"head_dim {hd}"):
            k4_caps(hd)


# ---------------------------------------------------------------------------
# Reduced gemma2 at head_dim 256
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma2():
    """(JAX cfg, port cfg, JAX params) of the reduced gemma2 (2 layers:
    one local, one global) at head_dim 256; the all-local variant has the
    same weights."""
    jcfg = jbase.get_config("gemma2-9b", reduced=True).replace(head_dim=256)
    tcfg = base.get_config("gemma2-9b", reduced=True).replace(head_dim=256)
    return jcfg, tcfg, japi.init(jax.random.PRNGKey(0), jcfg)


def _model(tcfg, params):
    return bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")


def _batch(vocab, t=24):
    """(port batch, JAX batch): a text row and a text + modality-1 +
    text row, with labels."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(2, t)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(2, t)).astype(np.int32)
    b1, p1 = bam.build_sample_bits(
        [("text", 0, 5), ("mod", 1, 9), ("text", 0, t - 14)], t)
    bits = np.stack([np.full(t, bam.text_token(), np.int32), b1])
    pos = np.stack([np.arange(t, dtype=np.int32), p1])
    tb = {"tokens": tokens, "labels": labels, "positions": pos,
          "bits": bits}
    jb = {k: jnp.asarray(v.astype(np.uint32) if k == "bits" else v)
          for k, v in tb.items()}
    return {k: torch.from_numpy(v) for k, v in tb.items()}, jb


def test_gemma2_all_local_on_bam_kernel_matches_jax_interpret(gemma2):
    """The all-local variant (every layer windowed, so attention takes
    the kernel path with bits): the forward and one AdamW step through K1
    (forward) and K2/K3 (backward), their plain versions on the CPU,
    against JAX's interpret-mode kernels."""
    jcfg, tcfg, params = gemma2
    model = _model(tcfg, params)
    jcfg = jcfg.replace(attn_impl="bam_interpret", local_global_pattern=0)
    tcfg = tcfg.replace(attn_impl="bam_kernel", local_global_pattern=0)
    tb, jb = _batch(tcfg.vocab_size)
    with torch.no_grad():
        got, _ = api.forward(model, tcfg, tb)
    want, _ = japi.forward(params, jcfg, jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    ocfg = dict(OCFG)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**ocfg)))
    tstep = steps.make_train_step(tcfg, opt.AdamWConfig(**ocfg))
    model.requires_grad_(True)
    params, _, jm = jstep(params, jopt.init(jopt.AdamWConfig(**ocfg), params),
                          jb)
    model, _, tm = tstep(model, opt.init(opt.AdamWConfig(**ocfg),
                                         dict(model.named_parameters())), tb)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=REL, err_msg=key)
    _close_params(bridge.to_jax_params(model, tcfg), params)
    assert bam_flash_attention.launches == 0


def test_gemma2_engine_matches_jax_engine(gemma2):
    """The alternating model (local window 16, global) through the
    port's engine on the kernel path (the prefill plain, as in JAX;
    decode through K4's plain version at head_dim 256) against the JAX
    engine: identical greedy tokens for a text and a multimodal
    prompt."""
    jcfg, tcfg, params = gemma2
    model = _model(tcfg, params)
    rng = np.random.default_rng(3)
    bits, pos = bam.build_sample_bits(
        [("text", 0, 4), ("mod", 1, 8), ("text", 0, 10)], 22)
    reqs = [dict(tokens=rng.integers(1, 512, size=22), bits=bits,
                 positions=pos, gen_bits=bam.text_token((1,)),
                 max_new_tokens=4),
            dict(tokens=rng.integers(1, 512, size=19), max_new_tokens=4)]
    jeng = JServingEngine(params, jcfg.replace(attn_impl="bam_interpret"),
                          num_pages=24, page_size=8, max_batch=2,
                          attn="interpret")
    jrids = [jeng.submit(**dict(r, bits=None if r.get("bits") is None
                                else r["bits"].astype(np.uint32)))
             for r in reqs]
    jout = jeng.run()
    eng = ServingEngine(model, tcfg.replace(attn_impl="bam_kernel"),
                        num_pages=24, page_size=8, max_batch=2,
                        attn="kernel", device="cpu")
    rids = [eng.submit(**r) for r in reqs]
    out = eng.run()
    assert [out[r] for r in rids] == [jout[r] for r in jrids]
    assert all(len(out[r]) == 4 for r in rids)
    assert paged_decode_attention.launches == 0
