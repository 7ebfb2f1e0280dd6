"""The port's stage partition of a real MLLM (``repro_torch.models.
stages``) replayed through ``execute_schedule``, on the reduced vlm in
f32 on the CPU.

The replay of a plan's timeline must give the port's single-process
step (``make_mllm_train_step``'s loss_fn and autograd) within LOSS_RTOL
for loss/M and GRAD_RTOL/GRAD_ATOL for gradients/M, the tolerances of
the JAX package's own replay test, for the searched plan, for each
schedule pinned, and for an ft1 plan (trainable LLM) pinned to ZB-H1,
whose W items run as separate autograd passes; with remat on and off
and with attn_impl "xla" and "bam_kernel" (K1-K3's plain versions
here). Frozen parameters get no gradient and no ``.grad``. The replay
also agrees with JAX's ``execute_schedule`` over JAX's stage bundle on
the same weights (``bridge``) and batch. The K1/K2/K3 calls it makes
(counted at their plain versions) are the ones ``chip_smoke.py``
derives for the card."""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from repro.core.modality_parallel import execute_schedule as jexecute
from repro.data import synthetic as jdata
from repro.models.mllm import build_paper_mllm as jbuild
from repro.models.stages import build_mllm_stages as jstages
from repro import parallel as jpar
from repro_torch import bridge
from repro_torch import parallel as tpar
from repro_torch.core.modality_parallel import execute_schedule
from repro_torch.data import synthetic as tdata
from repro_torch.kernels import bam_attention as KB
from repro_torch.models.mllm import build_paper_mllm as tbuild
from repro_torch.models.stages import build_mllm_stages
from repro_torch.training.steps import _grads, make_mllm_train_step

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import pp_expected_launches  # noqa: E402

LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
TEXT, M, BATCH = 16, 2, 2
SCHEDULES = ("1f1b", "interleaved", "zb-h1", "zb-v")


def case(train_llm=False, schedules=SCHEDULES, remat=False,
         impl="bam_kernel", pkg=tpar, mllm=None):
    mm = mllm or (tbuild if pkg is tpar else jbuild)("vlm", reduced=True)
    if train_llm:
        mm.freeze("llm", module=False)
    mm.llm_cfg = mm.llm_cfg.replace(remat=remat, attn_impl=impl)
    enc = mm.encoders["vision"]
    enc.cfg = enc.cfg.replace(remat=remat)
    plan = pkg.parallelize(
        mm, pkg.ClusterSpec(num_devices=3),
        pkg.WorkloadShape(text_len=TEXT, num_microbatches=M,
                          block_size=8), schedules=schedules)
    return mm, plan, plan.apply(mm, text_len=TEXT)


def batch_of(pkg, mm, **kw):
    return next(iter(pkg.MultimodalDataset(
        vocab_size=mm.llm_cfg.vocab_size, text_len=TEXT, batch_size=BATCH,
        encoder_dims={n: e.cfg.d_model for n, e in mm.encoders.items()},
        encoder_tokens={n: e.num_tokens for n, e in mm.encoders.items()},
        modality_ids={n: e.modality_id for n, e in mm.encoders.items()},
        **kw)))


def weights(tm):
    jm = jbuild("vlm", reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    return jp, bridge.mllm_from_jax_params(jax.tree.map(np.asarray, jp),
                                           tm, device="cpu")


def replay(tm, ex, params, batch):
    bundle = build_mllm_stages(tm, ex, text_len=TEXT)
    sp = bundle.partition(params)
    res = execute_schedule(bundle.stage_fns, sp,
                           bundle.encode_microbatches(batch, M),
                           ex["sim_graph"], ex["schedule"],
                           microbatch_loss=bundle.microbatch_loss,
                           trainable=list(bundle.trainable))
    grads = {}
    for g in res["param_grads"]:
        grads.update(g)
    return bundle, res, grads


def single_step(tm, params, batch):
    _, loss_fn = make_mllm_train_step(tm)
    named = dict(params.named_parameters())
    loss, _ = loss_fn(params, batch)
    return float(loss), _grads(loss, named)


def assert_replay_matches_step(tm, ex, params, batch):
    ref_loss, ref = single_step(tm, params, batch)
    bundle, res, grads = replay(tm, ex, params, batch)
    np.testing.assert_allclose(float(res["loss"]) / M, ref_loss,
                               rtol=LOSS_RTOL)
    assert set(grads) == {n for n, g in ref.items() if g is not None}
    for name, g in grads.items():
        np.testing.assert_allclose((g / M).numpy(), ref[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert all(p.grad is None for p in params.parameters())
    assert res["peak_activations_per_device"] == \
        ex["schedule"]["peak_activations_per_device"]
    return bundle, res


# ---------------------------------------------------------------------------
# The partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train_llm", [False, True])
def test_partition_roundtrip_and_trainable_flags(train_llm):
    tm, _, ex = case(train_llm)
    _, params = weights(tm)
    bundle = build_mllm_stages(tm, ex, text_len=TEXT)
    assert len(bundle.specs) == len(ex["sim_graph"].stages)
    sp = bundle.partition(params)
    whole = dict(params.named_parameters())
    seen = [n for st in sp for n, _ in st.named_parameters()]
    assert sorted(seen) == sorted(whole)          # each parameter once
    for st in sp:
        for n, p in st.named_parameters():
            assert p is whole[n]                  # shared, not copied
    back = bundle.unpartition(sp)
    assert [(n, p) for n, p in back.named_parameters()] == \
        [(n, p) for n, p in params.named_parameters()]
    masks = bundle.frozen_masks(sp)
    fmask = tm.frozen_mask(params)
    for s, mask in enumerate(masks):
        assert mask == {n: fmask[n] for n in mask}
        assert bundle.trainable[s] == (not all(mask.values()))
    assert any(bundle.trainable) and (train_llm or not all(bundle.trainable))
    with pytest.raises(ValueError, match="miss"):
        bundle.unpartition(sp[:-1])


@pytest.mark.parametrize("train_llm", [False, True])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_specs_and_carrier_equal_reference(train_llm, schedule):
    tm, tplan, tex = case(train_llm, (schedule,))
    jm, jplan, jex = case(train_llm, (schedule,), pkg=jpar, impl="xla")
    assert tplan.to_json() == jplan.to_json()
    tb = build_mllm_stages(tm, tex, text_len=TEXT)
    jb = jstages(jm, jex, text_len=TEXT)
    assert [vars(s) for s in tb.specs] == [vars(s) for s in jb.specs]
    assert tb.layout_meta == jb.layout_meta
    assert tb.slots == jb.slots and tb.n_text == jb.n_text
    got = tb.encode_microbatches(batch_of(tdata, tm, device="cpu"), M)
    want = jb.encode_microbatches(batch_of(jdata, jm), M)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_indivisible_batch_refused():
    tm, _, ex = case()
    bundle = build_mllm_stages(tm, ex, text_len=TEXT)
    with pytest.raises(ValueError, match="divisible"):
        bundle.encode_microbatches(batch_of(tdata, tm, device="cpu"), 3)


def test_stage_grouping_refuses_a_foreign_graph():
    tm, _, ex = case()
    other = tbuild("alm", reduced=True)
    with pytest.raises(ValueError, match="not an encoder"):
        build_mllm_stages(other, ex, text_len=TEXT)
    tm.layout = [("text", 8), ("vision",), ("text", 8)]
    with pytest.raises(ValueError, match="text length"):
        build_mllm_stages(tm, ex, text_len=TEXT + 1)


# ---------------------------------------------------------------------------
# The replay against the single step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["xla", "bam_kernel"])
def test_searched_plan_replay_matches_single_step(remat, impl):
    tm, _, ex = case(remat=remat, impl=impl)
    _, params = weights(tm)
    assert_replay_matches_step(tm, ex, params,
                               batch_of(tdata, tm, device="cpu"))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pinned_schedule_replay_matches_single_step(schedule):
    tm, plan, ex = case(schedules=(schedule,), remat=True)
    assert plan.schedule.name == schedule
    _, params = weights(tm)
    assert_replay_matches_step(tm, ex, params,
                               batch_of(tdata, tm, seed=3, device="cpu"))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["xla", "bam_kernel"])
def test_ft1_zbh1_replay_with_deferred_w(remat, impl):
    """A trainable LLM under ZB-H1: W items are separate autograd
    passes over graphs B kept; the W-residual store empties."""
    tm, plan, ex = case(train_llm=True, schedules=("zb-h1",), remat=remat,
                        impl=impl)
    assert plan.schedule.name == "zb-h1"
    assert any(it[3] == "W" for it in ex["schedule"]["items"])
    _, params = weights(tm)
    _, res = assert_replay_matches_step(tm, ex, params,
                                        batch_of(tdata, tm, device="cpu"))
    assert max(res["peak_w_residuals_per_device"]) > 0


def test_frozen_parameters_get_no_gradient():
    tm, _, ex = case()
    _, params = weights(tm)
    _, _, grads = replay(tm, ex, params, batch_of(tdata, tm, device="cpu"))
    fmask = tm.frozen_mask(params)
    assert grads and not any(fmask[n] for n in grads)
    assert all(n.startswith("encoders.vision.projector") for n in grads)
    assert all(p.grad is None for p in params.parameters())


# ---------------------------------------------------------------------------
# The replay against JAX's replay
# ---------------------------------------------------------------------------

def _jax_grads_by_name(tree, tm):
    flat = {}
    for name, enc in tree["encoders"].items():
        depth = tm.encoders[name].cfg.num_layers
        for key, arr in bridge.state_dict_from_jax(enc["module"],
                                                   depth).items():
            flat[f"encoders.{name}.module.{key}"] = arr
        for key, arr in enc["projector"].items():
            flat[f"encoders.{name}.projector.{key}"] = np.asarray(arr)
    for key, arr in bridge.state_dict_from_jax(
            tree["llm"], tm.llm_cfg.num_layers).items():
        flat[f"llm.{key}"] = arr
    return flat


@pytest.mark.parametrize("train_llm,schedules", [
    (False, SCHEDULES), (True, ("zb-h1",))])
def test_replay_equals_jax_replay(train_llm, schedules):
    tm, _, tex = case(train_llm, schedules)
    jm, _, jex = case(train_llm, schedules, pkg=jpar, impl="xla")
    jp, params = weights(tm)
    _, res, grads = replay(tm, tex, params,
                           batch_of(tdata, tm, device="cpu"))
    jb = jstages(jm, jex, text_len=TEXT)
    jres = jexecute(jb.stage_fns, jb.partition(jp),
                    jb.encode_microbatches(batch_of(jdata, jm), M),
                    jex["sim_graph"], jex["schedule"],
                    microbatch_loss=jb.microbatch_loss,
                    trainable=list(jb.trainable))
    np.testing.assert_allclose(float(res["loss"]), float(jres["loss"]),
                               rtol=LOSS_RTOL)
    jgrads = _jax_grads_by_name(jb.unpartition(jres["param_grads"]), tm)
    for name, arr in jgrads.items():
        if name in grads:
            np.testing.assert_allclose(grads[name].numpy(), arr,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=name)
        else:
            assert not np.asarray(arr).any(), name
    for key in ("peak_activations_per_device",
                "peak_w_residuals_per_device", "activation_trace"):
        assert res[key] == jres[key], key


# ---------------------------------------------------------------------------
# Kernel calls on the replay path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train_llm,schedules", [
    (False, SCHEDULES), (False, ("zb-v",)), (True, ("zb-h1",)),
    (True, ("1f1b",))])
@pytest.mark.parametrize("remat", [False, True])
def test_attention_calls_match_the_derivation(monkeypatch, train_llm,
                                              schedules, remat):
    calls = {"K1": 0, "K2": 0, "K3": 0}
    for key, name in (("K1", "bam_flash_attention_torch"),
                      ("K2", "bam_bwd_dq_torch"),
                      ("K3", "bam_bwd_dkv_torch")):
        def counted(*a, _f=getattr(KB, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(KB, name, counted)
    tm, _, ex = case(train_llm, schedules, remat=remat)
    _, params = weights(tm)
    bundle, _, _ = replay(tm, ex, params, batch_of(tdata, tm, device="cpu"))
    assert calls == pp_expected_launches(bundle, ex["sim_graph"],
                                         ex["schedule"], remat)
    assert calls["K2"] > 0
