"""The port's Whisper family (``repro_torch.models.whisper``) against the
JAX package's, f32 with TF32 off, on numpy-seeded inputs (frame
embeddings included) and JAX's weights carried over by
``repro_torch.bridge`` (``enc_layers`` and ``layers``).

Tolerances: encoder states, cross K/V and logits within 1e-5 of max
|value| (``_close``); the step's loss and grad_norm within 1e-5
relative; the parameters after one AdamW step within 1e-5 of max
|parameter| over the model (``_close_params``; AdamW eps 1e-3, for the
reason ``test_torch_moe`` gives).

- the configs field by field and ``param_count`` against the reference;
  ``sinusoid_pos`` (within 5e-5: the two ``exp``s differ by an ulp);
- the reduced whisper-base's encoder and forward, with bits (BAM's rule
  over the decoder tokens), without (causal), and on the ``bam_kernel``
  path, which routes no bits to the kernel, as in the reference;
- ``prefill_cross`` (the cross cache against JAX's) and ``decode_step``
  token by token against JAX's jitted one (self strips included) and
  against the port's forward;
- one AdamW ``make_train_step``; the bridge both ways.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import whisper as jw
from repro.optim import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.models import api, whisper
from repro_torch.optim import optimizer as opt
from repro_torch.training import steps

from .test_torch_hybrid import (  # noqa: F401
    _batch, _close, _close_params, _no_tf32)
from .test_torch_launch import _one_torch_thread  # noqa: F401

ARCH = "whisper-base"
REL = 1e-5
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=5, eps=1e-3)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The reduced config's JAX init at PRNGKey(0), once per process
    (jitted, which is faster than the eager init)."""
    return jax.jit(japi.init, static_argnums=1)(
        jax.random.PRNGKey(0), jbase.get_config(ARCH, reduced=True))


def _setup():
    """(JAX config, port config, JAX params, a fresh port model holding
    them)."""
    jcfg = jbase.get_config(ARCH, reduced=True)
    tcfg = base.get_config(ARCH, reduced=True)
    params = _jax_params()
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu")
    return jcfg, tcfg, params, model


def _frames(cfg, B=2, seed=5):
    """Frame embeddings [B, encoder_seq, d] of the embedding's scale."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, cfg.encdec.encoder_seq, cfg.d_model))
            * 0.5).astype(np.float32)


def _wbatch(cfg, t=24, bits=True):
    tb, jb = _batch(cfg.vocab_size, t=t)
    frames = _frames(cfg)
    tb["encoder_embeds"] = torch.from_numpy(frames)
    jb["encoder_embeds"] = jnp.asarray(frames)
    if not bits:
        del tb["bits"], jb["bits"]
    return tb, jb


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_and_param_count_equal_the_reference(reduced):
    jcfg = jbase.get_config(ARCH, reduced=reduced)
    tcfg = base.get_config(ARCH, reduced=reduced)
    assert isinstance(tcfg.encdec, base.EncDecConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert api.module_for(tcfg) is whisper
    assert not hasattr(whisper, "hidden")


def test_sinusoid_pos_matches_jax():
    """Within 5e-5 at positions up to Whisper's 448: XLA's and torch's
    f32 ``exp`` differ by one ulp on some of the 256 frequencies, which
    moves an angle by up to 447 x 2^-24 x freq, at most 2.7e-5."""
    pos = np.random.default_rng(0).integers(0, 448, (2, 9)).astype(np.int32)
    pos[0, 0] = 447
    _close(whisper.sinusoid_pos(torch.from_numpy(pos), 512).numpy(),
           jw.sinusoid_pos(jnp.asarray(pos), 512), rel=5e-5)


def test_encoder_matches_jax():
    jcfg, tcfg, params, model = _setup()
    frames = _frames(tcfg)
    with torch.no_grad():
        got = whisper.encode(model, tcfg, torch.from_numpy(frames))
    _close(got.numpy(), jw.encode(params, jcfg, jnp.asarray(frames)))


@pytest.mark.parametrize("bits,impl", [(True, "xla"), (False, "xla"),
                                       (True, "bam_kernel")],
                         ids=["bits", "causal", "bam_kernel"])
def test_forward_matches_jax(bits, impl):
    jcfg, tcfg, params, model = _setup()
    tb, jb = _wbatch(tcfg, bits=bits)
    with torch.no_grad():
        got, aux = api.forward(model, tcfg.replace(attn_impl=impl), tb)
    want, jaux = japi.forward(params, jcfg, jb)
    _close(got.numpy(), want)
    assert float(aux["aux_loss"]) == float(jaux["aux_loss"]) == 0.0


def test_prefill_cross_and_decode_match_jax_and_the_forward():
    jcfg, tcfg, params, model = _setup()
    n = 8
    frames = _frames(tcfg)
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, size=(2, n)).astype(np.int32)
    jstep = jax.jit(lambda p, c, b: japi.decode_step(p, jcfg, c, b))
    jc = jw.prefill_cross(params, jcfg, japi.init_cache(jcfg, 2, n),
                          jnp.asarray(frames))
    with torch.no_grad():
        tc = whisper.prefill_cross(model, tcfg,
                                   api.init_cache(tcfg, 2, n, device="cpu"),
                                   torch.from_numpy(frames))
    assert set(tc) == set(jc)
    for key in ("cross_k", "cross_v"):
        assert tc[key].shape == (tcfg.num_layers, 2, tcfg.encdec.encoder_seq,
                                 tcfg.num_kv_heads, tcfg.head_dim)
        _close(tc[key].numpy(), jc[key])
    got = []
    for t in range(n):
        tb = {"tokens": torch.from_numpy(tokens[:, t:t + 1]),
              "positions": torch.full((2, 1), t, dtype=torch.int32)}
        with torch.no_grad():
            tl, tc = api.decode_step(model, tcfg, tc, tb)
        jl, jc = jstep(params, jc, {k: jnp.asarray(v.numpy())
                                    for k, v in tb.items()})
        _close(tl.numpy(), jl)
        for key in ("k", "v"):
            _close(tc[key].numpy(), jc[key])
        got.append(tl[:, 0])
    pos = np.tile(np.arange(n, dtype=np.int32), (2, 1))
    with torch.no_grad():
        full, _ = api.forward(model, tcfg, {
            "tokens": torch.from_numpy(tokens),
            "positions": torch.from_numpy(pos),
            "encoder_embeds": torch.from_numpy(frames)})
    _close(torch.stack(got, 1).numpy(), full.numpy())


def test_train_step_matches_jax():
    jcfg, tcfg, params, model = _setup()
    tb, jb = _wbatch(tcfg)
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


def test_bridge_round_trip():
    jcfg, tcfg, params, model = _setup()
    want = jax.tree.map(np.asarray, params)
    assert {"enc_layers", "layers"} <= set(want)
    assert bridge.stack_depths(tcfg) == {"layers": 2, "enc_layers": 2}
    back = bridge.to_jax_params(model, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    own = api.init(tcfg, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    tb, jb = _wbatch(tcfg)
    with torch.no_grad():
        got, _ = api.forward(own, tcfg, tb)
    tree = jax.tree.map(jnp.asarray, bridge.to_jax_params(own, tcfg))
    _close(got.numpy(), japi.forward(tree, jcfg, jb)[0])
