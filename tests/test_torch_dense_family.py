"""The dense-family remainder of the port against the JAX package, f32
with TF32 off, on numpy-seeded inputs and JAX's weights carried over by
``repro_torch.bridge``: the four configs (gemma2-9b, qwen2.5-14b,
starcoder2-7b, qwen2-vl-7b) field by field; M-RoPE (``apply_mrope``,
``mrope_positions``, ``make_vlm_batch``); q-chunked plain attention
(``sdpa_q_chunked``, a forward with ``attn_q_chunk``); each reduced
config's forward on the "xla" path and on "bam_kernel" (K1's plain
version on the CPU, held against JAX's interpret-mode Pallas kernel);
and the bridge both ways."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import vlm as jvlm
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.core import bam
from repro_torch.models import api, layers, vlm

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("gemma2-9b", "qwen2.5-14b", "starcoder2-7b", "qwen2-vl-7b")
IMPLS = [("xla", "xla"), ("bam_interpret", "bam_kernel")]


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _setup(arch, **kw):
    """(JAX cfg, port cfg, JAX params, port model with those weights)."""
    jcfg = jbase.get_config(arch, reduced=True).replace(**kw)
    tcfg = base.get_config(arch, reduced=True).replace(**kw)
    params = japi.init(jax.random.PRNGKey(0), jcfg)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu")
    return jcfg, tcfg, params, model


def _to_jax(tb):
    """A port batch as the JAX package's (bits as uint32)."""
    out = {}
    for key, val in tb.items():
        arr = val.numpy()
        out[key] = jnp.asarray(arr.astype(np.uint32) if key == "bits"
                               else arr)
    return out


def lm_batch(vocab, t=32):
    """Two rows of t tokens: causal text, and text + a modality-1 stream
    + text."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(2, t)).astype(np.int32)
    b1, p1 = bam.build_sample_bits(
        [("text", 0, 5), ("mod", 1, 9), ("text", 0, t - 14)], t)
    bits = np.stack([np.full(t, bam.text_token(), np.int32), b1])
    pos = np.stack([np.arange(t, dtype=np.int32), p1])
    return {"tokens": torch.from_numpy(tokens),
            "positions": torch.from_numpy(pos), "bits": torch.from_numpy(bits)}


def vlm_batch(cfg, t=32, img_start=6, grid=(1, 4, 4), seed=0):
    """Both packages' ``make_vlm_batch`` on the same tokens and patch
    embeddings: (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, t)).astype(np.int32)
    n = int(np.prod(grid))
    patches = rng.normal(size=(2, n, cfg.d_model)).astype(np.float32)
    jb = jvlm.make_vlm_batch(jnp.asarray(tokens), jnp.asarray(patches),
                             img_start, grid, cfg.d_model)
    tb = vlm.make_vlm_batch(torch.from_numpy(tokens),
                            torch.from_numpy(patches), img_start, grid,
                            cfg.d_model)
    return jb, tb


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("deepseek-moe-16b", "qwen2-moe-a2.7b", "zamba2-2.7b")
VARIANTS = [(a, v) for a in ARCHS + FAMILY_ARCHS
            for v in ("full", "reduced")] + [("gemma2-9b", "long")]


@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_configs_equal_the_reference(arch, variant):
    if variant == "long":
        from repro.configs import gemma2_9b as jg
        from repro_torch.configs import gemma2_9b as tg
        jcfg, tcfg = jg.long_context_variant(), tg.long_context_variant()
    else:
        reduced = variant == "reduced"
        jcfg = jbase.get_config(arch, reduced=reduced)
        tcfg = base.get_config(arch, reduced=reduced)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.q_dim == jcfg.q_dim and tcfg.kv_dim == jcfg.kv_dim


def test_vlm_dispatch_and_refusals():
    from repro_torch.models import mamba2, moe, whisper, xlstm
    cfg = base.get_config("qwen2-vl-7b")
    assert api.module_for(cfg) is vlm
    assert not hasattr(vlm, "hidden")
    assert isinstance(cfg.mm, base.MultimodalConfig)
    assert api.module_for(cfg.replace(family="moe")) is moe
    assert api.module_for(cfg.replace(family="hybrid")) is mamba2
    assert api.module_for(cfg.replace(family="ssm")) is xlstm
    assert api.module_for(cfg.replace(family="audio")) is whisper


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections", [(64, (8, 12, 12)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_jax(hd, sections):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 3, hd)).astype(np.float32)
    pos3 = np.stack([jvlm.mrope_positions(40, 5, (2, 3, 4)),
                     jvlm.mrope_positions(40, 9, (1, 5, 5))], axis=1)
    pos3 = pos3 * np.int32(50)                        # large angles too
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             sections, 1e6)
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections, 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # text tokens (equal streams) reduce to plain RoPE
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    np.testing.assert_allclose(
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                           sections, 1e6).numpy(),
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]),
                          1e6).numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="sum to"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                           (1, 1, 1), 1e6)


@pytest.mark.parametrize("grid", [(1, 4, 4), (2, 2, 3)])
def test_mrope_positions_and_vlm_batch_equal(grid):
    for t, start in ((30, 0), (30, 7), (40, 11)):
        np.testing.assert_array_equal(
            vlm.mrope_positions(t, start, grid),
            jvlm.mrope_positions(t, start, grid))
    cfg = base.get_config("qwen2-vl-7b", reduced=True)
    jb, tb = vlm_batch(cfg, grid=grid)
    assert set(tb) == set(jb)
    for key in jb:
        want = np.asarray(jb[key])
        got = tb[key].numpy()
        if key == "bits":
            assert got.dtype == np.int32
            got = got.astype(np.uint32)
        assert got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)


# ---------------------------------------------------------------------------
# q-chunked plain attention
# ---------------------------------------------------------------------------

def test_sdpa_q_chunked_matches_jax():
    rng = np.random.default_rng(2)
    B, Tq, H, hd = 2, 24, 4, 16
    q, k, v = (rng.normal(size=(B, Tq, H, hd)).astype(np.float32)
               for _ in range(3))
    pos = np.tile(np.arange(Tq, dtype=np.int32), (B, 1))
    pos[1, 10:] += 3

    def t_mask(start, size):
        p = torch.from_numpy(pos)
        return layers.causal_mask(p[:, start:start + size], p, window=7)

    def j_mask(start, size):
        p = jnp.asarray(pos)
        return jl.causal_mask(jax.lax.dynamic_slice_in_dim(p, start, size, 1),
                              p, window=7)

    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = layers.sdpa_q_chunked(qt, kt, vt, t_mask, 8, softcap=20.0)
    want = jl.sdpa_q_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             j_mask, 8, softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    whole = layers.sdpa(qt, kt, vt, t_mask(0, Tq), softcap=20.0)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
    # each chunk is rematerialised under autograd: same gradients
    qg = qt.clone().requires_grad_()
    g1, = torch.autograd.grad(
        layers.sdpa_q_chunked(qg, kt, vt, t_mask, 8).square().sum(), qg)
    g2, = torch.autograd.grad(
        layers.sdpa(qg, kt, vt, t_mask(0, Tq)).square().sum(), qg)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        layers.sdpa_q_chunked(qt, kt, vt, t_mask, 7)


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2-vl-7b"])
def test_forward_q_chunk_matches_jax(arch):
    jcfg, tcfg, params, model = _setup(arch, attn_q_chunk=8)
    if arch == "qwen2-vl-7b":
        jb, tb = vlm_batch(tcfg)
    else:
        tb = lm_batch(tcfg.vocab_size)
        jb = _to_jax(tb)
    with torch.no_grad():
        got, _ = api.forward(model, tcfg, tb)
        plain, _ = api.forward(model, tcfg.replace(attn_q_chunk=0), tb)
    want, _ = japi.forward(params, jcfg, jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Forward of each reduced config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("j_impl,t_impl", IMPLS)
def test_forward_matches_jax(arch, j_impl, t_impl):
    jcfg, tcfg, params, model = _setup(arch)
    jcfg, tcfg = jcfg.replace(attn_impl=j_impl), tcfg.replace(attn_impl=t_impl)
    if arch == "qwen2-vl-7b":
        jb, tb = vlm_batch(tcfg)
    else:
        tb = lm_batch(tcfg.vocab_size)
        jb = _to_jax(tb)
    with torch.no_grad():
        got, _ = api.forward(model, tcfg, tb)
    want, _ = japi.forward(params, jcfg, jb)
    assert got.shape == (2, 32, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gemma2_window_bites():
    """The reduced gemma2's window (16) changes the logits at T = 32
    (so the forward test above holds the window, not just causality)."""
    _, tcfg, _, model = _setup("gemma2-9b")
    tb = lm_batch(tcfg.vocab_size)
    with torch.no_grad():
        a, _ = api.forward(model, tcfg, tb)
        b, _ = api.forward(model, tcfg.replace(sliding_window=0), tb)
    assert torch.allclose(a[:, :16], b[:, :16], rtol=1e-6, atol=1e-6)
    assert float((a[:, 16:] - b[:, 16:]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# The bridge, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip(arch):
    jcfg, tcfg, params, model = _setup(arch)
    want = jax.tree.map(np.asarray, params)
    back = bridge.to_jax_params(model, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # a model the port initialised loads into the JAX forward
    own = api.init(tcfg, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    if arch == "qwen2-vl-7b":
        jb, tb = vlm_batch(tcfg)
    else:
        tb = lm_batch(tcfg.vocab_size)
        jb = _to_jax(tb)
    with torch.no_grad():
        got, _ = api.forward(own, tcfg, tb)
    tree = jax.tree.map(jnp.asarray, bridge.to_jax_params(own, tcfg))
    want_logits, _ = japi.forward(tree, jcfg, jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_logits), **TOL)


def test_bridge_carries_every_parameter_kind():
    """QKV biases, post-block norms, tied embeddings, LayerNorm biases
    and the ungated GELU MLP, each as the JAX tree has it."""
    kinds = {"gemma2-9b": ("post_ln1", "post_ln2", "w_gate"),
             "qwen2.5-14b": ("bq", "bk", "bv", "unembed"),
             "starcoder2-7b": ("bq", "ln1.b", "final_ln.b")}
    for arch, names in kinds.items():
        _, tcfg, params, model = _setup(arch)
        flat = bridge.state_dict_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg.num_layers)
        state = model.state_dict()
        assert set(flat) == set(state)
        for name in names:
            assert any(name in key for key in state), (arch, name)
    _, tcfg, _, model = _setup("gemma2-9b")
    assert model.unembed is None
    _, tcfg, _, model = _setup("starcoder2-7b")
    assert model.layers[0].mlp.w_gate is None
    assert not any("w_gate" in key for key in model.state_dict())
