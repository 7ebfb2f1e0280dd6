"""``cfg.remat`` in the port: each LLM block (``transformer.hidden``) and
each encoder block (``mllm.encoder_forward``) runs under non-reentrant
``torch.utils.checkpoint`` when the flag is set and autograd records, as
the JAX package wraps them in ``jax.checkpoint``. f32 on the CPU, 2
layers:

- the reduced qwen3-1.7b LM loss and the reduced vlm MLLM loss: with
  remat the loss and every gradient are bit-identical to remat=False,
  and the attention forward runs twice per layer per step (once more in
  the backward's recompute) against once without. The frozen vlm
  encoder runs under ``no_grad``, so once either way; a trainable one is
  recomputed too. The kernel path (``BamAttention``, int32 bits saved)
  and the context-parallel step's Functions (world size 1, gloo) re-run
  correctly under the recompute;
- both steps agree with the JAX package's under the same flag: loss rel
  1e-5, grad_norm rel 1e-4 (the port's train-step tolerances).
"""
import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.data import synthetic as jdata
from repro.models import api as japi
from repro.models import mllm as jmllm
from repro.optim import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core import bam
from repro_torch.data import synthetic as tdata
from repro_torch.models import layers as L
from repro_torch.models import mllm as tmllm
from repro_torch.optim import optimizer as topt
from repro_torch.parallel import plan_context
from repro_torch.training import steps as tsteps

OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=5)
T, B = 48, 2


@pytest.fixture
def attention_calls(monkeypatch):
    """{config name: run_attention calls}, counted from here on."""
    calls = {}
    inner = L.run_attention

    def counted(p, cfg, *args, **kw):
        calls[cfg.name] = calls.get(cfg.name, 0) + 1
        return inner(p, cfg, *args, **kw)

    monkeypatch.setattr(L, "run_attention", counted)
    return calls


def _lm_batches(vocab, n=3):
    """Multimodal bits (text, a modality-1 stream, text) so the kernel
    path runs; numpy, so both packages get the same arrays."""
    bits, pos = bam.build_sample_bits(
        [("text", 0, 12), ("mod", 1, 16), ("text", 0, 20)], T)
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, vocab, (B, T)).astype(np.int32),
             "labels": rng.integers(0, vocab, (B, T)).astype(np.int32),
             "positions": np.stack([pos] * B), "bits": np.stack([bits] * B),
             "valid": np.stack([bits != 0] * B)} for _ in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(x) for k, x in b.items()}


def _lm(remat, impl="bam_kernel"):
    jcfg = j_get_config("qwen3-1.7b", reduced=True).replace(remat=remat)
    cfg = get_config("qwen3-1.7b", reduced=True).replace(remat=remat,
                                                         attn_impl=impl)
    params = japi.init(jax.random.PRNGKey(0), jcfg)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu")
    model.requires_grad_(True)
    return jcfg, cfg, params, model


def _grads(loss_fn, model, batch):
    named = dict(model.named_parameters())
    loss, _ = loss_fn(model, batch)
    names = [n for n, p in named.items() if p.requires_grad]
    return loss.detach(), dict(zip(names, torch.autograd.grad(
        loss, [named[n] for n in names])))


def _assert_bit_identical(a, b):
    (loss_a, grads_a), (loss_b, grads_b) = a, b
    assert torch.equal(loss_a, loss_b)
    assert grads_a.keys() == grads_b.keys() and grads_a
    for name in grads_a:
        assert torch.equal(grads_a[name], grads_b[name]), name


# ---------------------------------------------------------------------------
# LM step (reduced qwen3-1.7b)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "bam_kernel"])
def test_lm_remat_gradients_bit_identical(impl, attention_calls):
    batch = _torch_batch(_lm_batches(512, 1)[0])
    runs, counts = {}, {}
    for remat in (False, True):
        _, cfg, _, model = _lm(remat, impl)
        attention_calls.clear()
        runs[remat] = _grads(tsteps.make_loss_fn(cfg), model, batch)
        counts[remat] = attention_calls.get(cfg.name, 0)
        n_layers = cfg.num_layers
    _assert_bit_identical(runs[False], runs[True])
    assert counts == {False: n_layers, True: 2 * n_layers}
    # without grad (serving, evaluation) nothing is recomputed
    _, cfg, _, model = _lm(True, impl)
    attention_calls.clear()
    with torch.no_grad():
        tsteps.make_loss_fn(cfg)(model, batch)
    assert attention_calls[cfg.name] == n_layers


@pytest.mark.parametrize("remat", [False, True])
def test_lm_remat_steps_match_jax(remat):
    """3 steps of make_train_step, port (kernel path) against JAX (xla)
    under the same flag."""
    jcfg, cfg, params, model = _lm(remat)
    ocfg = dict(OCFG)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**ocfg)))
    tstep = tsteps.make_train_step(cfg, topt.AdamWConfig(**ocfg))
    jstate = jopt.init(jopt.AdamWConfig(**ocfg), params)
    tstate = topt.init(topt.AdamWConfig(**ocfg),
                       dict(model.named_parameters()))
    for i, b in enumerate(_lm_batches(cfg.vocab_size)):
        jb = {k: jnp.asarray(x.astype(np.uint32) if k == "bits" else x)
              for k, x in b.items()}
        params, jstate, jm = jstep(params, jstate, jb)
        model, tstate, tm = tstep(model, tstate, _torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")


# ---------------------------------------------------------------------------
# MLLM step (reduced vlm)
# ---------------------------------------------------------------------------

def _vlm(remat, frozen_encoder=True):
    jm = jmllm.build_paper_mllm("vlm", reduced=True)
    tm = tmllm.build_paper_mllm("vlm", reduced=True)
    for m in (jm, tm):
        m.llm_cfg = m.llm_cfg.replace(remat=remat)
        enc = m.encoders["vision"]
        enc.cfg = enc.cfg.replace(remat=remat)
        m.freeze("vision", module=frozen_encoder)
    tm.llm_cfg = tm.llm_cfg.replace(attn_impl="bam_kernel")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.mllm_from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                     device="cpu")
    tm.apply_freeze(tp)
    return jm, tm, jp, tp


def _vlm_data(pkg, mm, **kw):
    enc = mm.encoders["vision"]
    return iter(pkg.MultimodalDataset(
        vocab_size=mm.llm_cfg.vocab_size, text_len=32, batch_size=2,
        encoder_dims={"vision": enc.cfg.d_model},
        encoder_tokens={"vision": enc.num_tokens},
        modality_ids={"vision": enc.modality_id}, seed=2, **kw))


@pytest.mark.parametrize("frozen_encoder", [True, False])
def test_mllm_remat_gradients_bit_identical(frozen_encoder, attention_calls):
    runs, counts = {}, {}
    for remat in (False, True):
        _, tm, _, tp = _vlm(remat, frozen_encoder)
        batch = next(_vlm_data(tdata, tm, device="cpu"))
        _, loss_fn = tsteps.make_mllm_train_step(tm)
        attention_calls.clear()
        runs[remat] = _grads(loss_fn, tp, batch)
        counts[remat] = dict(attention_calls)
    _assert_bit_identical(runs[False], runs[True])
    llm = tm.llm_cfg
    enc = tm.encoders["vision"].cfg
    assert counts[False] == {llm.name: llm.num_layers,
                             enc.name: enc.num_layers}
    # the LLM is recomputed; the frozen encoder runs under no_grad once
    assert counts[True] == {
        llm.name: 2 * llm.num_layers,
        enc.name: (1 if frozen_encoder else 2) * enc.num_layers}
    if not frozen_encoder:          # the encoder's weights got gradients
        assert any(n.startswith("encoders.vision.module") for n in runs[True][1])


@pytest.mark.parametrize("remat", [False, True])
def test_mllm_remat_steps_match_jax(remat):
    jm, tm, jp, tp = _vlm(remat)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep, _ = jsteps.make_mllm_train_step(jm, jopt.AdamWConfig(**ocfg))
    jstep = jax.jit(jstep)
    tstep, _ = tsteps.make_mllm_train_step(tm, topt.AdamWConfig(**ocfg))
    jstate = jopt.init(jopt.AdamWConfig(**ocfg), jp, jm.frozen_mask(jp))
    tstate = topt.init(topt.AdamWConfig(**ocfg),
                       dict(tp.named_parameters()), tm.frozen_mask(tp))
    jit, tit = _vlm_data(jdata, jm), _vlm_data(tdata, tm, device="cpu")
    for i in range(3):
        jp, jstate, jmet = jstep(jp, jstate, next(jit))
        tp, tstate, tmet = tstep(tp, tstate, next(tit))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")


# ---------------------------------------------------------------------------
# The context-parallel step (world size 1): its Functions under recompute
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("method", ["allgather", "ring"])
@pytest.mark.parametrize("impl", ["xla", "bam_kernel"])
def test_cp_step_remat_bit_identical(method, impl, group, attention_calls):
    """One make_cp_train_step step on a 2-rank plan's layout (exact on one
    rank): with remat, the loss, grad_norm and updated weights equal
    remat=False's bit for bit, and attention runs twice per layer."""
    b = _lm_batches(512, 1)[0]
    layout = plan_context(b["bits"][0], b["positions"][0], 2, block_size=4,
                          method="lpt").apply(T)
    results = {}
    for remat in (False, True):
        _, cfg, _, model = _lm(remat, impl)
        ocfg = topt.AdamWConfig(**OCFG)
        state = topt.init(ocfg, dict(model.named_parameters()))
        with pytest.warns(UserWarning, match="balanced for 2 ranks"):
            step = tsteps.make_cp_train_step(cfg, layout, group, ocfg,
                                             method=method)
        attention_calls.clear()
        model, _, met = step(model, state, _torch_batch(b))
        results[remat] = (met["loss"], met["grad_norm"],
                          copy.deepcopy(dict(model.named_parameters())),
                          attention_calls[cfg.name])
    (l0, g0, p0, n0), (l1, g1, p1, n1) = results[False], results[True]
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert (n0, n1) == (cfg.num_layers, 2 * cfg.num_layers)
