"""The port's Mamba2/zamba2 hybrid family (``repro_torch.models.mamba2``)
against the JAX package's, f32 with TF32 off, on numpy-seeded inputs and
JAX's weights carried over by ``repro_torch.bridge`` (the shared
attention block as ``shared_attn``).

Tolerances: SSD outputs and states, and f32 logits, within 1e-5 of max
|value| (``_close``); the step's loss and grad_norm within 1e-5
relative; the parameters after one AdamW step within 1e-5 of max
|parameter| over the model (``_close_params``; AdamW eps 1e-3, for the
reason ``test_torch_moe`` gives).

- ``ssd_chunked`` against a loop of ``ssd_step`` and against JAX's
  ``ssd_chunked``, from a zero and from a given state;
- the reduced zamba2's forward, ``decode_step`` token by token (against
  JAX's jitted one, the SSM/conv states and the shared block's strips
  included, and against the port's forward) and one AdamW
  ``make_train_step``;
- the shared block on the ``bam_kernel`` path against JAX's
  interpret-mode kernel (head_dim 64 in both packages);
- the bridge both ways.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import mamba2 as jm2
from repro.optim import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.core import bam
from repro_torch.models import api, mamba2
from repro_torch.optim import optimizer as opt
from repro_torch.training import steps

from .test_torch_launch import _one_torch_thread  # noqa: F401

ARCH = "zamba2-2.7b"
REL = 1e-5
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=5, eps=1e-3)


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _close(got, want, rel=REL):
    """max |got - want| <= rel x max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max |d| {err:.3e} > {rel} x {scale:.3e}"


def _close_params(got_tree, want_tree, rel=REL):
    """Every leaf within ``rel`` x the largest |parameter| of the model
    (a leaf that starts at 0, as A_log or dt_bias, holds one update
    after a step)."""
    got, want = jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_tree),
                            want):
        err = float(np.abs(np.asarray(g, np.float64)
                           - np.asarray(w, np.float64)).max())
        assert err <= rel * scale, (jax.tree_util.keystr(path), err, scale)


def _setup(**kw):
    jcfg = jbase.get_config(ARCH, reduced=True).replace(**kw)
    tcfg = base.get_config(ARCH, reduced=True).replace(**kw)
    params = japi.init(jax.random.PRNGKey(0), jcfg)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu")
    return jcfg, tcfg, params, model


def _batch(vocab, t=32):
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


def _ssd_inputs(B=2, T=24, nh=3, hd=4, ds=5, seed=0):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, T, nh, hd)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, T, ds)).astype(np.float32)
              for _ in range(2))
    dt = np.log1p(np.exp(rng.normal(size=(B, T, nh)))).astype(np.float32)
    log_a = (-np.exp(rng.normal(size=(nh,)) * 0.5) * dt).astype(np.float32)
    h0 = rng.normal(size=(B, nh, hd, ds)).astype(np.float32)
    return (xh, Bm, Cm, dt, log_a), h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_steps_and_jax(with_h0):
    arrs, h0 = _ssd_inputs()
    t_in = [torch.from_numpy(a) for a in arrs]
    th0 = torch.from_numpy(h0) if with_h0 else None
    y, h = mamba2.ssd_chunked(*t_in, 8, th0)
    jy, jh = jm2.ssd_chunked(*(jnp.asarray(a) for a in arrs), 8,
                             jnp.asarray(h0) if with_h0 else None)
    _close(y.numpy(), jy)
    _close(h.numpy(), jh)
    # the recurrence one token at a time
    state = th0 if with_h0 else torch.zeros(h.shape)
    ys = []
    for t in range(arrs[0].shape[1]):
        yt, state = mamba2.ssd_step(*(a[:, t:t + 1] for a in t_in), state)
        ys.append(yt)
    _close(torch.cat(ys, 1).numpy(), y.numpy())
    _close(state.numpy(), h.numpy())
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        mamba2.ssd_chunked(*t_in, 7)


def test_ssd_chunked_grads_finite_on_a_long_chunk():
    """zamba2's own chunk of 128 tokens with a strong decay: above the
    diagonal cum_t - cum_i reaches hundreds, where exp overflows. The
    chunked SSD's gradients stay finite and equal autograd through the
    recurrence (``ssd_step`` token by token); the JAX package's
    ``ssd_chunked``, which selects after the exp, gives NaN here."""
    arrs, _ = _ssd_inputs(B=1, T=256, nh=2, hd=4, ds=3, seed=4)
    xh, Bm, Cm, dt, _ = arrs
    log_a = np.full_like(dt, -2.0)          # exp(2 x 127) overflows f32

    def grads(run):
        t_in = [torch.from_numpy(a).requires_grad_()
                for a in (xh, Bm, Cm, dt, log_a)]
        y, h = run(*t_in)
        (y.square().sum() + h.sum()).backward()
        return [t.grad for t in t_in]

    def steps_(*t_in):
        state = torch.zeros((1, 2, 4, 3))
        ys = []
        for t in range(xh.shape[1]):
            yt, state = mamba2.ssd_step(*(a[:, t:t + 1] for a in t_in),
                                        state)
            ys.append(yt)
        return torch.cat(ys, 1), state

    got = grads(lambda *a: mamba2.ssd_chunked(*a, 128))
    want = grads(steps_)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close(g.numpy(), w.numpy(), rel=1e-4)


def test_forward_matches_jax():
    jcfg, tcfg, params, model = _setup()
    tb, jb = _batch(tcfg.vocab_size)
    with torch.no_grad():
        got, aux = api.forward(model, tcfg, tb)
    want, jaux = japi.forward(params, jcfg, jb)
    _close(got.numpy(), want)
    assert float(aux["aux_loss"]) == float(jaux["aux_loss"]) == 0.0


def test_decode_matches_jax_and_the_forward():
    jcfg, tcfg, params, model = _setup()
    n = 16
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, size=(2, n)).astype(np.int32)
    jstep = jax.jit(lambda p, c, b: japi.decode_step(p, jcfg, c, b))
    jc = japi.init_cache(jcfg, 2, n)
    tc = api.init_cache(tcfg, 2, n, device="cpu")
    assert set(tc) == set(jc)
    got = []
    for t in range(n):
        tb = {"tokens": torch.from_numpy(tokens[:, t:t + 1]),
              "positions": torch.full((2, 1), t, dtype=torch.int32)}
        with torch.no_grad():
            tl, tc = api.decode_step(model, tcfg, tc, tb)
        jl, jc = jstep(params, jc, {k: jnp.asarray(v.numpy())
                                    for k, v in tb.items()})
        _close(tl.numpy(), jl)
        for key in ("ssm", "conv", "attn_k", "attn_v"):
            _close(tc[key].numpy(), jc[key])
        np.testing.assert_array_equal(tc["bits"].numpy().astype(np.uint32),
                                      np.asarray(jc["bits"]))
        got.append(tl[:, 0])
    pos = np.tile(np.arange(n, dtype=np.int32), (2, 1))
    with torch.no_grad():
        full, _ = api.forward(model, tcfg, {
            "tokens": torch.from_numpy(tokens),
            "positions": torch.from_numpy(pos)})
    _close(torch.stack(got, 1).numpy(), full.numpy())


def test_train_step_matches_jax():
    jcfg, tcfg, params, model = _setup()
    tb, jb = _batch(tcfg.vocab_size)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**OCFG)))
    tstep = steps.make_train_step(tcfg, opt.AdamWConfig(**OCFG))
    model.requires_grad_(True)
    params, _, jm = jstep(params, jopt.init(jopt.AdamWConfig(**OCFG), params),
                          jb)
    model, _, tm = tstep(model, opt.init(opt.AdamWConfig(**OCFG),
                                         dict(model.named_parameters())), tb)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=REL, err_msg=key)
    _close_params(bridge.to_jax_params(model, tcfg), params)


def test_bam_kernel_path_matches_jax_interpret():
    """The shared block on the ``bam_kernel`` path (K1's plain version on
    the CPU) against JAX's interpret-mode kernel, for each head_dim in
    both packages: 64 (the kernels' wgmma body in bf16 on the card) and
    zamba2's 80 (their SIMT body; ``chip_smoke.py``'s hybrid phase holds
    the full-width prefill and train step there)."""
    for head_dim in (64, 80):
        jcfg, tcfg, params, model = _setup(head_dim=head_dim)
        tb, jb = _batch(tcfg.vocab_size)
        with torch.no_grad():
            got, _ = api.forward(model, tcfg.replace(attn_impl="bam_kernel"),
                                 tb)
        want, _ = japi.forward(params,
                               jcfg.replace(attn_impl="bam_interpret"), jb)
        _close(got.numpy(), want)


def test_bridge_round_trip():
    jcfg, tcfg, params, model = _setup()
    want = jax.tree.map(np.asarray, params)
    assert "shared_attn" in want and "dense_layers" not in want
    back = bridge.to_jax_params(model, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert model.layers[0].A_log.dtype == torch.float32
    own = api.init(tcfg, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    tb, jb = _batch(tcfg.vocab_size)
    with torch.no_grad():
        got, _ = api.forward(own, tcfg, tb)
    tree = jax.tree.map(jnp.asarray, bridge.to_jax_params(own, tcfg))
    _close(got.numpy(), japi.forward(tree, jcfg, jb)[0])
