"""The port's frozen-aware MLLM train step against the JAX package's,
f32 on the CPU, with JAX's weights carried over by
``repro_torch.bridge.mllm_from_jax_params``.

Pieces: the encoder configs; the datasets (the same seed gives equal
arrays); ``build_merge``; the encoder and MLLM forward (rtol/atol
1e-4); cross-entropy, chunked and not; AdamW over 5 steps with a frozen
mask (rtol 1e-6). The slice as a whole: 10 steps of the reduced vlm and
valm models through ``make_mllm_train_step`` match the reference's
loss (rel 1e-5) and grad_norm (rel 1e-4) at every step, the reference
run both at attn_impl="xla" and at "bam_interpret" (the port at
"bam_kernel": K1/K2/K3's plain versions on the CPU), and the frozen
parameters stay bit-identical.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import paper_mllm as jconfigs
from repro.data import synthetic as jdata
from repro.models import mllm as jmllm
from repro.models import transformer as jT
from repro.optim import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import paper_mllm as tconfigs
from repro_torch.data import synthetic as tdata
from repro_torch.models import mllm as tmllm
from repro_torch.models import transformer as tT
from repro_torch.optim import optimizer as topt
from repro_torch.training import steps as tsteps

TOL = dict(rtol=1e-4, atol=1e-4)
TEXT_LEN = 32
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _models(kind, j_impl="xla", t_impl="bam_kernel"):
    jm = jmllm.build_paper_mllm(kind, reduced=True)
    tm = tmllm.build_paper_mllm(kind, reduced=True)
    jm.llm_cfg = jm.llm_cfg.replace(attn_impl=j_impl)
    tm.llm_cfg = tm.llm_cfg.replace(attn_impl=t_impl)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.mllm_from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                     device="cpu")
    return jm, tm, jp, tp


def _dataset(pkg, mm, seed=0, **kw):
    encs = mm.encoders
    return pkg.MultimodalDataset(
        vocab_size=mm.llm_cfg.vocab_size, text_len=TEXT_LEN, batch_size=2,
        encoder_dims={n: e.cfg.d_model for n, e in encs.items()},
        encoder_tokens={n: e.num_tokens for n, e in encs.items()},
        modality_ids={n: e.modality_id for n, e in encs.items()},
        seed=seed, **kw)


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Configs and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["vision_encoder_config",
                                   "audio_encoder_config", "llm_config"])
@pytest.mark.parametrize("size", ["S", "M", "L"])
@pytest.mark.parametrize("reduced", [False, True])
def test_paper_configs_match_jax(which, size, reduced):
    j = getattr(jconfigs, which)(size, reduced)
    t = getattr(tconfigs, which)(size, reduced)
    for field in ("name", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size", "norm",
                  "act", "dtype", "rope_theta", "loss_chunk", "source"):
        assert getattr(t, field) == getattr(j, field), field
    if which == "vision_encoder_config" and size == "S" and not reduced:
        assert (t.num_heads, t.head_dim) == (16, 88)     # EVA-CLIP-S


@pytest.mark.parametrize("noise", [0.1, 1.0])
def test_text_dataset_matches_jax(noise):
    kw = dict(vocab_size=97, seq_len=12, batch_size=3, seed=5, noise=noise)
    jit, tit = iter(jdata.TextLMDataset(**kw)), iter(
        tdata.TextLMDataset(**kw, device="cpu"))
    for _ in range(2):
        jb, tb = next(jit), next(tit)
        assert set(jb) == set(tb)
        for key in jb:
            assert tb[key].dtype == torch.int32
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))


@pytest.mark.parametrize("mode,docs", [("ee", 1), ("ep", 1), ("mp", 3)])
def test_multimodal_dataset_matches_jax(mode, docs):
    mm = jmllm.build_paper_mllm("valm", reduced=True)
    jd = _dataset(jdata, mm, seed=7, mask_mode=mode, docs_per_row=docs)
    td = _dataset(tdata, mm, seed=7, mask_mode=mode, docs_per_row=docs,
                  device="cpu")
    jit, tit = iter(jd), iter(td)
    for _ in range(2):
        jb, tb = next(jit), next(tit)
        assert set(jb) == set(tb)
        for key in jb:
            assert tb[key].dtype == (torch.float32 if key.endswith("embeds")
                                     else torch.int32)
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    for got, want in zip(td.merged_bits(), jd.merged_bits()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tdata.random_multimodal_bits(256, mode, seed=3),
                         jdata.random_multimodal_bits(256, mode, seed=3)):
        np.testing.assert_array_equal(got, want)


def test_entry_points_default_to_the_card():
    mm = tmllm.build_paper_mllm("vlm", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mm.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(iter(_dataset(tdata, mm)))


# ---------------------------------------------------------------------------
# Merge and forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["vlm", "valm"])
def test_merge_and_forward_match_jax(kind):
    jm, tm, jp, tp = _models(kind)
    jbatch = next(iter(_dataset(jdata, jm, seed=1)))
    tbatch = next(iter(_dataset(tdata, tm, seed=1, device="cpu")))
    assert tm.default_layout(TEXT_LEN) == jm.default_layout(TEXT_LEN)
    assert tm.merged_length(TEXT_LEN) == jm.merged_length(TEXT_LEN)
    # encoder outputs, then the merged batch
    j_enc, t_enc = {}, {}
    for name in sorted(jm.encoders):
        j_enc[name] = jm.encoders[name].forward(jp["encoders"][name], jbatch)
        t_enc[name] = tm.encoders[name].forward(tp.encoders[name], tbatch)
        np.testing.assert_allclose(t_enc[name].detach().numpy(),
                                   np.asarray(j_enc[name]), **TOL)
        np.testing.assert_allclose(
            tmllm.encoder_forward(tp.encoders[name].module,
                                  tm.encoders[name].cfg,
                                  tbatch[f"{name}_embeds"]).detach().numpy(),
            np.asarray(jmllm.encoder_forward(
                jp["encoders"][name]["module"], jm.encoders[name].cfg,
                jbatch[f"{name}_embeds"])), **TOL)
    jmerged = jm.build_merge(jbatch["text_tokens"], j_enc)
    tmerged = tm.build_merge(tbatch["text_tokens"], t_enc)
    for key in ("tokens", "positions", "bits", "embed_mask"):
        np.testing.assert_array_equal(
            tmerged[key].numpy(),
            np.asarray(jmerged[key]).astype(tmerged[key].numpy().dtype))
    np.testing.assert_allclose(tmerged["inputs_embeds"].detach().numpy(),
                               np.asarray(jmerged["inputs_embeds"]), **TOL)
    (jl, _), _ = jm.forward(jp, jbatch)
    with torch.no_grad():
        (tl, _), _ = tm.forward(tp, tbatch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_bridge_carries_the_whole_tree_and_freezes():
    jm, tm, jp, tp = _models("valm")
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        flat[tuple(p.key for p in path)] = np.asarray(leaf)
    n_port = sum(p.numel() for p in tp.parameters())
    assert n_port == sum(a.size for a in flat.values())
    wq = flat[("encoders", "audio", "module", "layers", "attn", "wq")]
    for i, blk in enumerate(tp.encoders["audio"].module.layers):
        np.testing.assert_array_equal(blk.attn.wq.detach().numpy(), wq[i])
    np.testing.assert_array_equal(
        tp.encoders["vision"].projector.w1.detach().numpy(),
        flat[("encoders", "vision", "projector", "w1")])
    mask = tm.frozen_mask(tp)
    trainable = sorted(n for n, frozen in mask.items() if not frozen)
    assert trainable == ["encoders.audio.projector.w1",
                         "encoders.vision.projector.w1"]
    assert all(p.requires_grad == (not mask[n])
               for n, p in tp.named_parameters())
    bad = jax.tree.map(np.asarray, jp)
    bad["encoders"]["vision"]["projector"]["w9"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="w9"):
        bridge.mllm_from_jax_params(bad, tm, device="cpu")


# ---------------------------------------------------------------------------
# Losses and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("with_valid", [False, True])
def test_cross_entropy_matches_jax(chunk, with_valid):
    from repro.configs.paper_mllm import llm_config as j_llm
    from repro_torch.configs.paper_mllm import llm_config as t_llm
    jcfg, tcfg = j_llm("M", True), t_llm("M", True)
    jparams = jT.init(jax.random.PRNGKey(1), jcfg)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                   device="cpu")
    rng = np.random.default_rng(0)
    h = rng.normal(size=(2, 24, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    valid = rng.random((2, 24)) < 0.6 if with_valid else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    want = jsteps.chunked_cross_entropy(jnp.asarray(h), jparams, jcfg,
                                        jnp.asarray(labels), jv, chunk=chunk)
    ht = torch.from_numpy(h).requires_grad_()
    got = tsteps.chunked_cross_entropy(ht, model, tcfg,
                                       torch.from_numpy(labels), tv,
                                       chunk=chunk)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    got.backward()
    gwant = jax.grad(lambda h: jsteps.chunked_cross_entropy(
        h, jparams, jcfg, jnp.asarray(labels), jv, chunk=chunk))(
            jnp.asarray(h))
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gwant),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_matches_jax(schedule):
    j = jopt.AdamWConfig(warmup_steps=3, total_steps=12, schedule=schedule)
    t = topt.AdamWConfig(warmup_steps=3, total_steps=12, schedule=schedule)
    # f32 both; cos may differ by an ulp between numpy and XLA
    for step in range(0, 15):
        np.testing.assert_allclose(topt.lr_at(t, step),
                                   np.float32(jopt.lr_at(j, step)),
                                   rtol=1e-6)


def test_adamw_with_frozen_mask_matches_jax():
    """5 steps over a small tree with one frozen leaf: parameters,
    moments, grad_norm and lr as the JAX update gives them; the frozen
    leaf is never written and holds no state."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (4,), "frozen": (2, 2)}
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    mask = {"a": False, "b": False, "frozen": True}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    jstate = jopt.init(jcfg, jp, mask)
    tp = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    tstate = topt.init(tcfg, tp, mask)
    assert tstate["m"]["frozen"] is None and tstate["v"]["frozen"] is None
    for _ in range(5):
        g = {n: rng.normal(size=s).astype(np.float32)
             for n, s in shapes.items()}
        g["frozen"] = np.zeros(shapes["frozen"], np.float32)
        jp, jstate, jm = jopt.update(
            jcfg, {n: jnp.asarray(a) for n, a in g.items()}, jstate, jp, mask)
        tgrads = {n: torch.from_numpy(a) for n, a in g.items()}
        tgrads["frozen"] = None                      # no grad: counts as 0
        _, tstate, tm = topt.update(tcfg, tgrads, tstate, tp, mask)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        for n in ("a", "b"):
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tstate["m"][n].numpy(),
                                       np.asarray(jstate["m"][n]), rtol=1e-6,
                                       atol=1e-8)
            np.testing.assert_allclose(tstate["v"][n].numpy(),
                                       np.asarray(jstate["v"][n]), rtol=1e-6,
                                       atol=1e-8)
        assert tstate["step"] == int(jstate["step"])
    np.testing.assert_array_equal(tp["frozen"].numpy(), p0["frozen"])


def test_lm_train_step_matches_jax():
    """make_train_step on the reduced paper LLM (nothing frozen), chunked
    loss, 3 steps: loss and grad_norm as the JAX step."""
    from repro.configs.paper_mllm import llm_config as j_llm
    from repro_torch.configs.paper_mllm import llm_config as t_llm
    jcfg = j_llm("M", True).replace(loss_chunk=8)
    tcfg = t_llm("M", True).replace(loss_chunk=8)
    jparams = jT.init(jax.random.PRNGKey(2), jcfg)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                   device="cpu")
    model.requires_grad_(True)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=5)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**ocfg)))
    tstep = tsteps.make_train_step(tcfg, topt.AdamWConfig(**ocfg))
    jstate = jopt.init(jopt.AdamWConfig(**ocfg), jparams)
    tstate = topt.init(topt.AdamWConfig(**ocfg),
                       dict(model.named_parameters()))
    jit = iter(jdata.TextLMDataset(tcfg.vocab_size, 16, 2, seed=3))
    tit = iter(tdata.TextLMDataset(tcfg.vocab_size, 16, 2, seed=3,
                                   device="cpu"))
    for _ in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, next(jit))
        model, tstate, tm = tstep(model, tstate, next(tit))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)


# ---------------------------------------------------------------------------
# The slice: the frozen-aware MLLM train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["vlm", "valm"])
@pytest.mark.parametrize("j_impl", ["xla", "bam_interpret"])
def test_mllm_train_steps_match_jax(kind, j_impl):
    jm, tm, jp, tp = _models(kind, j_impl=j_impl, t_impl="bam_kernel")
    frozen0 = {n: p.detach().clone() for n, p in tp.named_parameters()
               if not p.requires_grad}
    proj0 = tp.encoders["vision"].projector.w1.detach().clone()
    jstep, _ = jsteps.make_mllm_train_step(jm, jopt.AdamWConfig(**OCFG))
    jstep = jax.jit(jstep)
    tstep, _ = tsteps.make_mllm_train_step(tm, topt.AdamWConfig(**OCFG))
    jstate = jopt.init(jopt.AdamWConfig(**OCFG), jp, jm.frozen_mask(jp))
    tstate = topt.init(topt.AdamWConfig(**OCFG),
                       dict(tp.named_parameters()), tm.frozen_mask(tp))
    jit = iter(_dataset(jdata, jm, seed=2))
    tit = iter(_dataset(tdata, tm, seed=2, device="cpu"))
    for step in range(10):
        jp, jstate, jmet = jstep(jp, jstate, next(jit))
        tp, tstate, tmet = tstep(tp, tstate, next(tit))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
    for n, p in tp.named_parameters():
        if n in frozen0:
            assert torch.equal(p.detach(), frozen0[n]), n
            assert p.grad is None and tstate["m"][n] is None
    moved = tp.encoders["vision"].projector.w1
    assert not torch.equal(moved.detach(), proj0)
    # Adam divides by sqrt(v): an element whose gradient is near zero can
    # move by up to lr per step on rounding noise, so atol is 1% of lr
    np.testing.assert_allclose(
        moved.detach().numpy(),
        np.asarray(jp["encoders"]["vision"]["projector"]["w1"]),
        rtol=1e-4, atol=1e-5)
