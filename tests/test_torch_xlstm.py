"""The port's xLSTM family (``repro_torch.models.xlstm``) against the JAX
package's, f32 with TF32 off, on numpy-seeded inputs and JAX's weights
carried over by ``repro_torch.bridge`` (``mlstm_layers`` and
``slstm_layers``).

Tolerances: mLSTM/sLSTM outputs and states, logits and gradients within
1e-5 of max |value| (``_close``); the step's loss and grad_norm within
1e-5 relative; the parameters after one AdamW step within 1e-5 of max
|parameter| over the model (``_close_params``; AdamW eps 1e-3, for the
reason ``test_torch_moe`` gives). T stays <= 32: the sLSTM time loop
runs op by op on the host.

- the configs field by field and ``param_count`` against the reference;
- ``mlstm_chunked`` against ``mlstm_parallel`` and both against JAX's
  (from a zero and from a given state); ``_slstm_cell`` from the -inf
  initial stabilizer and from a finite one;
- the reduced xlstm-125m's forward on the chunked and the parallel mLSTM
  path, ``decode_step`` token by token (against JAX's jitted one, every
  state included, and against the port's forward), one AdamW
  ``make_train_step``, and one sLSTM block's gradients through the time
  loop against ``jax.grad`` through ``lax.scan``; the time loop's
  hand-written backward (``_slstm_scan``) against autograd through a
  loop of ``_slstm_cell``;
- the bridge both ways.
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
from repro.models import xlstm as jx
from repro.optim import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.models import api, xlstm
from repro_torch.optim import optimizer as opt
from repro_torch.training import steps

from .test_torch_hybrid import (  # noqa: F401
    _batch, _close, _close_params, _no_tf32)
from .test_torch_launch import _one_torch_thread  # noqa: F401

ARCH = "xlstm-125m"
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


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_and_param_count_equal_the_reference(reduced):
    jcfg = jbase.get_config(ARCH, reduced=reduced)
    tcfg = base.get_config(ARCH, reduced=reduced)
    assert isinstance(tcfg.xlstm, base.XLSTMConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert api.module_for(tcfg) is xlstm
    assert xlstm._dims(tcfg) == jx._dims(jcfg)


def _mlstm_inputs(B=2, T=24, nh=2, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, nh, hd)).astype(np.float32)
               for _ in range(3))
    log_i = rng.normal(size=(B, T, nh)).astype(np.float32)
    f = rng.normal(size=(B, T, nh)).astype(np.float32) + 2
    log_f = -np.log1p(np.exp(-f)).astype(np.float32)
    state = (rng.normal(size=(B, nh, hd, hd)).astype(np.float32),
             rng.normal(size=(B, nh, hd)).astype(np.float32),
             rng.normal(size=(B, nh)).astype(np.float32))
    return (q, k, v, log_i, log_f), state


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_parallel_and_jax(with_state):
    arrs, st = _mlstm_inputs()
    t_in = [torch.from_numpy(a) for a in arrs]
    j_in = [jnp.asarray(a) for a in arrs]
    t_st = tuple(torch.from_numpy(a) for a in st) if with_state else None
    j_st = tuple(jnp.asarray(a) for a in st) if with_state else None
    h, (C, n, m) = xlstm.mlstm_chunked(*t_in, 8, t_st)
    jh, (jC, jn, jm) = jx.mlstm_chunked(*j_in, 8, j_st)
    for got, want in ((h, jh), (C, jC), (n, jn), (m, jm)):
        _close(got.numpy(), want)
    if not with_state:
        par = xlstm.mlstm_parallel(*t_in)
        _close(par.numpy(), jx.mlstm_parallel(*j_in))
        _close(h.numpy(), par.numpy())
    with pytest.raises(ValueError, match="multiple of the mLSTM chunk"):
        xlstm.mlstm_chunked(*t_in, 7)


@pytest.mark.parametrize("first", [True, False], ids=["m=-inf", "m finite"])
def test_slstm_cell_matches_jax(first):
    jcfg, tcfg, params, model = _setup()
    lp = model.slstm_layers[0]
    jlp = jax.tree.map(lambda a: a[0], params["slstm_layers"])
    rng = np.random.default_rng(1)
    B, d, nh = 3, tcfg.d_model, tcfg.num_heads
    zifo = rng.normal(size=(B, 4 * d)).astype(np.float32)
    st = [rng.normal(size=(B, d)).astype(np.float32) for _ in range(3)]
    st.append(np.full((B, nh), -np.inf, np.float32) if first
              else rng.normal(size=(B, nh)).astype(np.float32))
    if first:
        st[:3] = [np.zeros_like(s) for s in st[:3]]
    got = xlstm._slstm_cell(lp, tcfg, torch.from_numpy(zifo),
                            tuple(torch.from_numpy(s) for s in st))
    want = jx._slstm_cell(jlp, jcfg, jnp.asarray(zifo),
                          tuple(jnp.asarray(s) for s in st))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close(g.numpy(), w)


@pytest.mark.parametrize("B,T_", [(2, 24), (1, 512)])
def test_slstm_scan_equals_the_cell_loop(B, T_):
    """``_slstm_scan`` (the hand-written backward through time) against
    ``_slstm_cell`` looped under autograd, in the port alone: h and the
    final state, and the gradients of the inputs, the recurrent weights
    and the biases, finite and within 1e-5 of max. At B 1 the forward's
    one-row products and the backward's batched recompute of the gates
    round differently (a saved stabilizer then missed its argmax and
    gave NaN)."""
    _, tcfg, _, model = _setup()
    lp = model.slstm_layers[0]
    lp.requires_grad_(True)
    rng = np.random.default_rng(4)
    d = tcfg.d_model
    x = torch.from_numpy(rng.normal(size=(B, T_, d)).astype(np.float32))
    zifo = (x @ lp.w_zifo).detach()               # the block's own scale
    w = torch.from_numpy(rng.normal(size=(B, T_, d)).astype(np.float32))

    def grads(fn):
        z = zifo.clone().requires_grad_(True)
        hs, state = fn(z)
        (hs * w).sum().backward()
        out = [hs.detach(), *(s.detach() for s in state), z.grad,
               lp.r_zifo.grad, lp.b_zifo.grad]
        lp.zero_grad()
        return out

    def loop(z):
        state = (torch.zeros(B, d), torch.zeros(B, d), torch.zeros(B, d),
                 torch.full((B, tcfg.num_heads), float("-inf")))
        hs = []
        for t in range(T_):
            state = xlstm._slstm_cell(lp, tcfg, z[:, t], state)
            hs.append(state[2])
        return torch.stack(hs, 1), state
    for got, want in zip(grads(lambda z: xlstm._slstm_scan(lp, tcfg, z)),
                         grads(loop)):
        assert bool(torch.isfinite(got).all())
        _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("t", [16, 20], ids=["chunked", "parallel"])
def test_forward_matches_jax(t):
    jcfg, tcfg, params, model = _setup()
    tb, jb = _batch(tcfg.vocab_size, t=t)
    with torch.no_grad():
        got, aux = api.forward(model, tcfg, tb)
    want, jaux = japi.forward(params, jcfg, jb)
    _close(got.numpy(), want)
    assert float(aux["aux_loss"]) == float(jaux["aux_loss"]) == 0.0


def test_decode_matches_jax_and_the_forward():
    jcfg, tcfg, params, model = _setup()
    n = 8
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
        for key in tc:
            _close(tc[key].numpy(), jc[key])
        got.append(tl[:, 0])
    pos = np.tile(np.arange(n, dtype=np.int32), (2, 1))
    with torch.no_grad():
        full, _ = api.forward(model, tcfg, {
            "tokens": torch.from_numpy(tokens),
            "positions": torch.from_numpy(pos)})
    _close(torch.stack(got, 1).numpy(), full.numpy())


def test_train_step_matches_jax():
    jcfg, tcfg, params, model = _setup()
    tb, jb = _batch(tcfg.vocab_size, t=16)
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


def test_slstm_gradients_match_jax_grad():
    """One sLSTM block over T 16 from the zero state (m = -inf at the
    first step): the gradients of a fixed projection of its output, for
    every weight and the input, finite and equal to ``jax.grad``'s
    through ``lax.scan``."""
    jcfg, tcfg, params, model = _setup()
    lp = model.slstm_layers[0]
    jlp = jax.tree.map(lambda a: a[0], params["slstm_layers"])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out, _, _ = jx.slstm_block(p, jcfg, x)
        return jnp.sum(out * jnp.asarray(w))
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jlp, jnp.asarray(x))

    lp.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _, _ = xlstm.slstm_block(lp, tcfg, tx)
    (out * torch.from_numpy(w)).sum().backward()
    _close(tx.grad.numpy(), jgx)
    got = bridge.jax_tree(
        {n: p.grad for n, p in lp.named_parameters()})
    flat = jax.tree_util.tree_leaves_with_path(jg)
    assert len(flat) == len(list(lp.parameters()))
    for path, want in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert bool(torch.isfinite(node).all()), jax.tree_util.keystr(path)
        _close(node.numpy(), want)


def test_bridge_round_trip():
    jcfg, tcfg, params, model = _setup()
    want = jax.tree.map(np.asarray, params)
    assert {"mlstm_layers", "slstm_layers"} <= set(want)
    assert bridge.stack_depths(tcfg) == {"mlstm_layers": 1,
                                         "slstm_layers": 1}
    back = bridge.to_jax_params(model, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert model.mlstm_layers[0].f_bias.dtype == torch.float32
    own = api.init(tcfg, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    tb, jb = _batch(tcfg.vocab_size, t=16)
    with torch.no_grad():
        got, _ = api.forward(own, tcfg, tb)
    tree = jax.tree.map(jnp.asarray, bridge.to_jax_params(own, tcfg))
    _close(got.numpy(), japi.forward(tree, jcfg, jb)[0])
