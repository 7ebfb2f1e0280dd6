"""The port's dense transformer against the JAX package's, with JAX's
weights carried over by ``repro_torch.bridge.from_jax_params``: forward
logits and the serving prefill's logits and per-layer K/V, f32 at
rtol/atol 1e-4, for the reduced paper LLM and reduced qwen3-1.7b
(qk_norm, decode_kv_replicate). The port's "bam_kernel" path (K1's plain
version on the CPU) is held against JAX's interpret-mode Pallas path."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.configs.paper_mllm import llm_config as j_llm_config
from repro.models import api as japi
from repro.serving.model import prefill_forward as j_prefill_forward
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.configs.paper_mllm import llm_config
from repro_torch.core import bam
from repro_torch.models import api, layers
from repro_torch.models import transformer as T
from repro_torch.serving.model import prefill_forward

TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = {
    "paper-llama-M": (lambda: j_llm_config("M", reduced=True),
                      lambda: llm_config("M", reduced=True)),
    "qwen3-1.7b": (lambda: j_get_config("qwen3-1.7b", reduced=True),
                   lambda: get_config("qwen3-1.7b", reduced=True)),
}
IMPLS = [("xla", "xla"), ("bam_interpret", "bam_kernel")]


def _setup(name):
    jcfg_fn, tcfg_fn = CONFIGS[name]
    jcfg, tcfg = jcfg_fn(), tcfg_fn()
    assert jcfg.name == tcfg.name and jcfg.head_dim == tcfg.head_dim
    params = japi.init(jax.random.PRNGKey(0), jcfg)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu")
    return jcfg, tcfg, params, model


def _batch(vocab):
    """Two rows of 24 tokens: causal text, and text + a modality-1
    stream + text."""
    rng = np.random.default_rng(0)
    t = 24
    tokens = rng.integers(0, vocab, size=(2, t)).astype(np.int32)
    b0 = np.full(t, bam.text_token(), np.int32)
    b1, p1 = bam.build_sample_bits(
        [("text", 0, 4), ("mod", 1, 8), ("text", 0, 12)], t)
    bits = np.stack([b0, b1])
    pos = np.stack([np.arange(t, dtype=np.int32), p1])
    jb = {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos),
          "bits": jnp.asarray(bits.astype(np.uint32))}
    tb = {"tokens": torch.from_numpy(tokens), "positions": torch.from_numpy(pos),
          "bits": torch.from_numpy(bits)}
    return jb, tb


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("j_impl,t_impl", IMPLS)
def test_forward_and_prefill_match_jax(name, j_impl, t_impl):
    jcfg, tcfg, params, model = _setup(name)
    jcfg, tcfg = jcfg.replace(attn_impl=j_impl), tcfg.replace(attn_impl=t_impl)
    jb, tb = _batch(tcfg.vocab_size)
    with torch.no_grad():
        got, _ = api.forward(model, tcfg, tb)
        gl, gk, gv = prefill_forward(model, tcfg, tb)
    want, _ = japi.forward(params, jcfg, jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    wl, wk, wv = j_prefill_forward(params, jcfg, jb)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    assert gk.shape == (tcfg.num_layers, 2, 24, tcfg.num_kv_heads,
                        tcfg.head_dim)


def test_bridge_unstacks_layers_exactly():
    jcfg, tcfg, params, model = _setup("qwen3-1.7b")
    wq = np.asarray(params["layers"]["attn"]["wq"])
    for i, block in enumerate(model.layers):
        np.testing.assert_array_equal(block.attn.wq.numpy(), wq[i])
        np.testing.assert_array_equal(
            block.attn.qnorm.numpy(),
            np.asarray(params["layers"]["attn"]["qnorm"])[i])
    assert model.unembed is None                      # tied embeddings
    assert not any(p.requires_grad for p in model.parameters())
    bad = jax.tree.map(np.asarray, params)
    bad["extra"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="extra"):
        bridge.from_jax_params(bad, tcfg, device="cpu")


def test_layers_match_jax_primitives():
    from repro.models import layers as jl
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    w = rng.normal(size=(8,)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1)) * 700
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        layers.rmsnorm(xt, torch.from_numpy(w)).numpy(),
        np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        layers.layernorm(xt, torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        np.asarray(jl.layernorm(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(
        layers.apply_rope(xt, torch.from_numpy(pos), 5e5).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)),
        **TOL)
    mask = np.tril(np.ones((5, 5), bool))
    mask[0] = False                                   # a row with no key
    got = layers.sdpa(xt, xt, xt, torch.from_numpy(mask)[None, None],
                      softcap=20.0)
    want = jl.sdpa(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                   jnp.asarray(mask)[None, None], softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[:, 0] == 0).all()


def test_entry_points_refuse_what_the_port_lacks():
    cfg = llm_config("M", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(cfg)                                 # default device="cuda"
    with pytest.raises(NotImplementedError, match="unknown model family"):
        api.module_for(cfg.replace(family="nope"))
    model = api.init(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    _, tb = _batch(cfg.vocab_size)
    for bad, err in ((dict(attn_impl="bam_interpret"), ValueError),
                     (dict(cp_mesh=object()), TypeError)):
        with pytest.raises(err):
            api.forward(model, cfg.replace(**bad), tb)
    with pytest.raises(ValueError, match="decode_kv_replicate=3"):
        T._cache_cfg(cfg.replace(decode_kv_replicate=3))
    # a seeded generator gives the same weights twice
    again = api.init(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(model.layers[1].mlp.w_gate, again.layers[1].mlp.w_gate)
