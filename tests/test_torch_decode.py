"""The port's strip-cache decode against the JAX package, f32 with TF32
off, JAX's weights carried over by ``repro_torch.bridge``:
``cache_update``/``cache_update_ragged`` exactly; ``decode_step`` token
by token (logits and the new cache) against JAX's jitted
``decode_step`` at 1e-4 and against the port's own forward at the
reference's 2e-3, for gemma2 (a window that bites, ``decode_kv_replicate``
4, two rows at ragged offsets) and qwen2-vl (``pos3``, a merged image
batch); ``make_prefill`` and 8 steps of ``make_serve_step`` (greedy
tokens equal, the cache at 1e-4)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import vlm as jvlm
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.models import api, layers, vlm
from repro_torch.training import steps

TOL = dict(rtol=1e-4, atol=1e-4)
FWD_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _setup(arch, **kw):
    jcfg = jbase.get_config(arch, reduced=True).replace(**kw)
    tcfg = base.get_config(arch, reduced=True).replace(**kw)
    params = japi.init(jax.random.PRNGKey(0), jcfg)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu")
    return jcfg, tcfg, params, model


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_cache(got, want, tol=TOL):
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), **tol,
                                   err_msg=key)
    np.testing.assert_array_equal(_np(got["bits"]).astype(np.uint32),
                                  _np(want["bits"]))


def _jax_batch(tb):
    return {k: jnp.asarray(v.numpy().astype(np.uint32) if k == "bits"
                           else v.numpy()) for k, v in tb.items()}


def test_cache_updates_are_exact():
    rng = np.random.default_rng(0)
    B, Tmax, Hkv, hd = 3, 9, 2, 4
    ck, cv = (rng.normal(size=(B, Tmax, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.normal(size=(B, 1, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    idx = np.array([4, 0, 8], np.int32)
    got = layers.cache_update_ragged(torch.from_numpy(ck.copy()),
                                     torch.from_numpy(cv.copy()),
                                     torch.from_numpy(kn),
                                     torch.from_numpy(vn),
                                     torch.from_numpy(idx))
    want = jl.cache_update_ragged(jnp.asarray(ck), jnp.asarray(cv),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    k3 = rng.normal(size=(B, 3, Hkv, hd)).astype(np.float32)
    got = layers.cache_update(torch.from_numpy(ck.copy()),
                              torch.from_numpy(cv.copy()),
                              torch.from_numpy(k3), torch.from_numpy(k3), 5)
    want = jl.cache_update(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(k3),
                           jnp.asarray(k3), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for arch in ("gemma2-9b", "qwen2-vl-7b"):
        jc = japi.init_cache(jbase.get_config(arch, reduced=True), 2, 7)
        tc = api.init_cache(base.get_config(arch, reduced=True), 2, 7,
                            device="cpu")
        _assert_cache(tc, jc)
        assert tc["k"].dtype == torch.float32
        assert tc["bits"].dtype == torch.int32
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(base.get_config("qwen2-vl-7b", reduced=True), 1, 4)


def _decode_run(jcfg, tcfg, params, model, feeds, Tmax):
    """Feed ``feeds`` (port batches [B,1]) through both packages'
    decode_step, holding logits and the new cache at 1e-4 after every
    step. Returns the port's logits [B, V] per step."""
    jstep = jax.jit(lambda p, c, b: japi.decode_step(p, jcfg, c, b))
    B = feeds[0]["tokens"].shape[0]
    jc = japi.init_cache(jcfg, B, Tmax)
    tc = api.init_cache(tcfg, B, Tmax, device="cpu")
    out = []
    for tb in feeds:
        with torch.no_grad():
            tl, tc = api.decode_step(model, tcfg, tc, tb)
        jlog, jc = jstep(params, jc, _jax_batch(tb))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jlog), **TOL)
        _assert_cache(tc, jc)
        out.append(tl[:, 0])
    return out


def test_decode_gemma2_window_replicate_ragged():
    """Two rows at ragged offsets: row 0 at position t, row 1 held at 0
    for three ticks (rewriting slot 0 with the same token) and then at
    t - 3. A window of 5 bites; the cache holds 4 replicated KV heads."""
    jcfg, tcfg, params, model = _setup("gemma2-9b", sliding_window=5)
    assert tcfg.decode_kv_replicate == 4 and tcfg.num_kv_heads == 2
    n = 14
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, size=(2, n)).astype(np.int32)
    feeds, where = [], []
    for t in range(n):
        p = np.array([t, max(t - 3, 0)], np.int32)
        feeds.append({"tokens": torch.from_numpy(toks[[0, 1], p][:, None]),
                      "positions": torch.from_numpy(p[:, None])})
        where.append(p)
    got = _decode_run(jcfg, tcfg, params, model, feeds, Tmax=n)
    assert got[0].shape == (2, tcfg.vocab_size)
    pos = torch.arange(n, dtype=torch.int32)[None].expand(2, n)
    with torch.no_grad():
        full, _ = api.forward(model, tcfg,
                              {"tokens": torch.from_numpy(toks),
                               "positions": pos})
        nowin, _ = api.forward(model, tcfg.replace(sliding_window=0),
                               {"tokens": torch.from_numpy(toks),
                                "positions": pos})
    assert float((full - nowin).abs().max()) > 1e-3      # the window bites
    for logits, p in zip(got, where):
        for row in range(2):
            np.testing.assert_allclose(logits[row].numpy(),
                                       full[row, p[row]].numpy(), **FWD_TOL)


def _row_feeds(batch, n):
    """Port batch [B,T] (pos3 [3,B,T]) sliced into n one-token batches."""
    feeds = []
    for t in range(n):
        f = {}
        for key, val in batch.items():
            f[key] = (val[:, :, t:t + 1] if key == "pos3"
                      else val[:, t:t + 1]).contiguous()
        feeds.append(f)
    return feeds


def test_decode_qwen2_vl_pos3():
    """The merged image batch token by token against JAX's decode_step
    (bits, embeds and pos3 carried); and, with pos3 from an image grid
    but causal text bits, against the port's forward (M-RoPE in the
    decode path matches the prefill's)."""
    jcfg, tcfg, params, model = _setup("qwen2-vl-7b")
    rng = np.random.default_rng(4)
    T_, start, grid = 24, 4, (1, 3, 4)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, T_)).astype(np.int32)
    patches = rng.normal(size=(2, 12, tcfg.d_model)).astype(np.float32)
    tb = vlm.make_vlm_batch(torch.from_numpy(tokens),
                            torch.from_numpy(patches), start, grid,
                            tcfg.d_model)
    _decode_run(jcfg, tcfg, params, model, _row_feeds(tb, T_), Tmax=T_)

    text = {"tokens": tb["tokens"], "positions": tb["positions"],
            "pos3": tb["pos3"]}
    assert int((text["pos3"][1] != text["pos3"][0]).sum()) > 0
    got = _decode_run(jcfg, tcfg, params, model, _row_feeds(text, T_),
                      Tmax=T_ + 2)
    with torch.no_grad():
        full, _ = api.forward(model, tcfg, text)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               **FWD_TOL)


@pytest.mark.parametrize("arch,kw", [("qwen2-vl-7b", {}),
                                     ("qwen2.5-14b", {"loss_chunk": 16})])
def test_prefill_and_serve_steps_match_jax(arch, kw):
    """``make_prefill`` (the full forward for vlm, which has no hidden;
    hidden plus a one-position unembed under loss_chunk) and 8 greedy
    ``make_serve_step`` ticks from an empty strip cache."""
    jcfg, tcfg, params, model = _setup(arch, **kw)
    rng = np.random.default_rng(5)
    if arch == "qwen2-vl-7b":
        tokens = rng.integers(0, tcfg.vocab_size, size=(2, 24)).astype(
            np.int32)
        patches = rng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)
        tb = vlm.make_vlm_batch(torch.from_numpy(tokens),
                                torch.from_numpy(patches), 3, (1, 4, 4),
                                tcfg.d_model)
        jb = jvlm.make_vlm_batch(jnp.asarray(tokens), jnp.asarray(patches),
                                 3, (1, 4, 4), tcfg.d_model)
    else:
        tokens = rng.integers(0, tcfg.vocab_size, size=(2, 24)).astype(
            np.int32)
        pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
        tb = {"tokens": torch.from_numpy(tokens),
              "positions": torch.from_numpy(pos)}
        jb = _jax_batch(tb)
    got = steps.make_prefill(tcfg)(model, tb)
    want = jsteps.make_prefill(jcfg)(params, jb)
    assert got.shape == (2, 1, tcfg.vocab_size) and not got.requires_grad
    # the [B,T,V] logits are not kept alive behind the last position
    assert got.untyped_storage().nbytes() == got.numel() * got.element_size()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    serve = steps.make_serve_step(tcfg)
    jserve = jax.jit(jsteps.make_serve_step(jcfg))
    tc = api.init_cache(tcfg, 2, 8, device="cpu")
    jc = japi.init_cache(jcfg, 2, 8)
    tok = got[:, -1].argmax(-1).to(torch.int32)
    jtok = jnp.asarray(tok.numpy())
    for t in range(8):
        p = torch.full((2, 1), t, dtype=torch.int32)
        tb1 = {"tokens": tok[:, None], "positions": p}
        if arch == "qwen2-vl-7b":
            tb1["pos3"] = p[None].expand(3, 2, 1).contiguous()
        jb1 = {k: jnp.asarray(v.numpy()) for k, v in tb1.items()}
        jb1["tokens"] = jtok[:, None]
        tok, tc = serve(model, tc, tb1)
        jtok, jc = jserve(params, jc, jb1)
        assert tok.dtype == torch.int32 and tok.shape == (2,)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        _assert_cache(tc, jc)
