"""The port's MoE family (``repro_torch.models.moe``) against the JAX
package's, f32 with TF32 off, on numpy-seeded inputs and JAX's weights
carried over by ``repro_torch.bridge`` (``layers`` and deepseek-moe's
``dense_layers``).

Tolerances: f32 logits within 1e-5 of max |logit| (``_close``); the aux
loss, the step's loss and grad_norm within 1e-5 relative; the
parameters after one AdamW step within 1e-5 of max |parameter| over the
model (``test_torch_hybrid._close_params``). The
step's AdamW eps is 1e-3 (``OCFG``): AdamW's first update is
g / (|g| + eps), and at the default eps 1e-8 an element whose gradient
is near 1e-8 turns a 1e-7 gradient difference (1e-6 of max |g|, f32
rounding of the expert sums) into a 3e-5 parameter difference; at 1e-3
the update is well conditioned and the parameters hold the gradients to
the stated tolerance.

- forward logits and aux loss of both reduced configs (dense backend);
  the router's top-k ids equal to JAX's; the capacity backend at
  ``capacity_factor`` 4.0 (nothing dropped) equal to the dense backend,
  and at 0.5 (pairs dropped, counted by ``torch_cp_ranks.kept_pairs``)
  against JAX's capacity dispatch;
- ``decode_step`` token by token against JAX's jitted one (both rows at
  one offset: deepseek's dense prefix writes every row at the first
  row's index, as JAX does) and against the port's own forward;
- one AdamW ``make_train_step`` of both reduced configs, also on the
  chunked-loss branch (``loss_chunk`` 16, where the aux loss comes from
  ``hidden``) and with capacity drops;
- the ``bam_kernel`` path (K1-K3's plain versions on the CPU) against
  JAX's interpret-mode Pallas path at ``head_dim`` 64 in both packages
  (the reduced configs' 32 is not a kernel head size);
- the bridge both ways, and the launcher's ``--arch deepseek-moe-16b
  --reduced`` run crashed and resumed from a checkpoint logging the
  uninterrupted losses.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.optim import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.core import bam
from repro_torch.launch import train as ttrain
from repro_torch.models import api, moe
from repro_torch.optim import optimizer as opt
from repro_torch.resilience import CrashInjected, Fault, FaultPlan
from repro_torch.training import steps

from .test_torch_hybrid import _close_params
from .test_torch_launch import _one_torch_thread  # noqa: F401
from .torch_cp_ranks import kept_pairs

ARCHS = ("deepseek-moe-16b", "qwen2-moe-a2.7b")
REL = 1e-5
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=5, eps=1e-3)


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _moe_kw(cfg, **moe_kw):
    return dict(moe=dataclasses.replace(cfg.moe, **moe_kw)) if moe_kw else {}


def _setup(arch, moe_kw=None, **kw):
    """(JAX cfg, port cfg, JAX params, port model with those weights)."""
    jcfg = jbase.get_config(arch, reduced=True)
    tcfg = base.get_config(arch, reduced=True)
    jcfg = jcfg.replace(**kw, **_moe_kw(jcfg, **(moe_kw or {})))
    tcfg = tcfg.replace(**kw, **_moe_kw(tcfg, **(moe_kw or {})))
    params = japi.init(jax.random.PRNGKey(0), jcfg)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu")
    return jcfg, tcfg, params, model


def _batch(vocab, t=32, seed=0):
    """Two rows of t tokens with labels: causal text, and text + a
    modality-1 stream + text. (port batch, JAX batch)"""
    rng = np.random.default_rng(seed)
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


def _close(got, want, rel=REL):
    """max |got - want| <= rel x max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max |d| {err:.3e} > {rel} x {scale:.3e}"


def _forward(jcfg, tcfg, params, model, tb, jb):
    with torch.no_grad():
        got, aux = api.forward(model, tcfg, tb)
    want, jaux = japi.forward(params, jcfg, jb)
    _close(got.numpy(), want)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=REL)
    return got


# ---------------------------------------------------------------------------
# Forward, router, dispatch backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_router_match_jax(arch):
    jcfg, tcfg, params, model = _setup(arch)
    tb, jb = _batch(tcfg.vocab_size)
    _forward(jcfg, tcfg, params, model, tb, jb)
    # the router's top-k on a hidden state: ids equal, weights close
    h = np.random.default_rng(1).normal(size=(2, 32, tcfg.d_model)).astype(
        np.float32)
    jlp = jax.tree.map(lambda a: a[0], params["layers"]["mlp"])
    jp, jw, jidx = jmoe.router_probs(jlp, jnp.asarray(h), jcfg)
    tp, tw, tidx = moe.router_probs(model.layers[0].mlp, torch.from_numpy(h),
                                    tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw.numpy(), jw)
    _close(tp.numpy(), jp)
    np.testing.assert_allclose(
        float(moe.aux_loss(tp, tidx, tcfg)),
        float(jmoe.aux_loss(jp, jidx, jcfg)), rtol=REL)


def test_capacity_without_drops_equals_dense():
    _, tcfg, _, model = _setup("deepseek-moe-16b")
    tb, _ = _batch(tcfg.vocab_size)
    cap = tcfg.replace(moe=dataclasses.replace(
        tcfg.moe, backend="capacity", capacity_factor=4.0))
    with torch.no_grad():
        with kept_pairs(model) as log:
            got, aux = api.forward(model, cap, tb)
        want, jaux = api.forward(model, tcfg, tb)
    assert len(log) == 2 and all(k == n for k, n in log)
    _close(got.numpy(), want.numpy())
    assert float(aux["aux_loss"]) == float(jaux["aux_loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_jax(arch):
    jcfg, tcfg, params, model = _setup(
        arch, moe_kw=dict(backend="capacity", capacity_factor=0.5))
    tb, jb = _batch(tcfg.vocab_size)
    with kept_pairs(model) as log:
        _forward(jcfg, tcfg, params, model, tb, jb)
    kept, routed = sum(k for k, _ in log), sum(n for _, n in log)
    assert 0 < kept < routed                      # pairs were dropped
    jstep, tstep, jstate, tstate = _steps(jcfg, tcfg, params, model)
    _step_match(jstep, tstep, jstate, tstate, params, model, tcfg, tb, jb)


def test_unknown_backend_is_refused():
    _, tcfg, _, model = _setup("qwen2-moe-a2.7b",
                               moe_kw=dict(backend="shardmap"))
    tb, _ = _batch(tcfg.vocab_size)
    with pytest.raises(ValueError, match="item 27"):
        api.forward(model, tcfg, tb)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_the_forward(arch):
    jcfg, tcfg, params, model = _setup(arch)
    rng = np.random.default_rng(3)
    n = 10
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, n)).astype(np.int32)
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
        for key in ("k", "v"):
            _close(tc[key].numpy(), jc[key])
        if "dense" in jc:
            for key in ("k", "v"):
                _close(tc["dense"][key].numpy(), jc["dense"][key])
        np.testing.assert_array_equal(tc["bits"].numpy().astype(np.uint32),
                                      np.asarray(jc["bits"]))
        got.append(tl[:, 0])
    pos = np.tile(np.arange(n, dtype=np.int32), (2, 1))
    with torch.no_grad():
        full, _ = api.forward(model, tcfg, {
            "tokens": torch.from_numpy(tokens),
            "positions": torch.from_numpy(pos)})
    _close(torch.stack(got, 1).numpy(), full.numpy())


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _steps(jcfg, tcfg, params, model):
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**OCFG)))
    tstep = steps.make_train_step(tcfg, opt.AdamWConfig(**OCFG))
    model.requires_grad_(True)
    return (jstep, tstep, jopt.init(jopt.AdamWConfig(**OCFG), params),
            opt.init(opt.AdamWConfig(**OCFG), dict(model.named_parameters())))


def _step_match(jstep, tstep, jstate, tstate, params, model, tcfg, tb, jb):
    params, _, jm = jstep(params, jstate, jb)
    model, _, tm = tstep(model, tstate, tb)
    for key in ("loss", "ce", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=REL, err_msg=key)
    assert float(tm["aux_loss"].detach()) > 0
    _close_params(bridge.to_jax_params(model, tcfg), params)


@pytest.mark.parametrize("arch,kw", [(a, {}) for a in ARCHS] + [
    ("deepseek-moe-16b", {"loss_chunk": 16})])
def test_train_step_matches_jax(arch, kw):
    jcfg, tcfg, params, model = _setup(arch, **kw)
    tb, jb = _batch(tcfg.vocab_size)
    jstep, tstep, jstate, tstate = _steps(jcfg, tcfg, params, model)
    _step_match(jstep, tstep, jstate, tstate, params, model, tcfg, tb, jb)


def test_bam_kernel_path_matches_jax_interpret():
    """Forward and one step with attention through K1 (forward) and
    K2/K3 (backward), their plain versions on the CPU, against JAX's
    interpret-mode kernel: head_dim 64 in both packages."""
    jcfg, tcfg, params, model = _setup("deepseek-moe-16b", head_dim=64)
    jcfg = jcfg.replace(attn_impl="bam_interpret")
    tcfg = tcfg.replace(attn_impl="bam_kernel")
    tb, jb = _batch(tcfg.vocab_size)
    _forward(jcfg, tcfg, params, model, tb, jb)
    jstep, tstep, jstate, tstate = _steps(jcfg, tcfg, params, model)
    _step_match(jstep, tstep, jstate, tstate, params, model, tcfg, tb, jb)


# ---------------------------------------------------------------------------
# The bridge and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip(arch):
    jcfg, tcfg, params, model = _setup(arch)
    want = jax.tree.map(np.asarray, params)
    assert ("dense_layers" in want) == (arch == "deepseek-moe-16b")
    back = bridge.to_jax_params(model, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # a model the port initialised runs in the JAX forward
    own = api.init(tcfg, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    tb, jb = _batch(tcfg.vocab_size)
    tree = jax.tree.map(jnp.asarray, bridge.to_jax_params(own, tcfg))
    _forward(jcfg, tcfg, tree, own, tb, jb)
    # every stacked group is held to its own depth
    depths = bridge.stack_depths(tcfg)
    group = "dense_layers" if "dense_layers" in depths else "layers"
    with pytest.raises(ValueError, match=f"{group} depth"):
        bridge.state_dict_from_jax(want, dict(depths,
                                              **{group: depths[group] + 1}))


def test_launcher_moe_crash_and_resume(tmp_path):
    argv = ["--arch", "deepseek-moe-16b", "--reduced", "--steps", "2",
            "--seq", "16", "--batch", "2", "--log-every", "0",
            "--device", "cpu"]
    ref = ttrain.main(argv)
    assert len(ref["losses"]) == 2 and all(np.isfinite(ref["losses"]))
    run = argv + ["--ckpt-dir", str(tmp_path / "run"), "--ckpt-every", "1"]
    plan = str(tmp_path / "crash.json")
    FaultPlan.make([Fault("crash", 1)]).save(plan)
    with pytest.raises(CrashInjected):
        ttrain.main(run + ["--fault-plan", plan])
    res = ttrain.main(run + ["--resume"])
    assert res["resilience"]["losses"] == {1: ref["losses"][1]}


def test_shapes_and_skips_equal_the_reference():
    assert {n: dataclasses.asdict(s) for n, s in base.SHAPES.items()} == \
        {n: dataclasses.asdict(s) for n, s in jbase.SHAPES.items()}
    assert base.SKIPS == jbase.SKIPS
    assert base.LONG_CONTEXT_OK == jbase.LONG_CONTEXT_OK
    for arch in jbase.list_archs():
        for shape in jbase.SHAPES:
            assert base.pair_skip_reason(arch, shape) == \
                jbase.pair_skip_reason(arch, shape)
    # the port registers every arch of the reference
    assert base.list_archs() == jbase.list_archs()
