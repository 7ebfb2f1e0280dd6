"""``make_cp_train_step`` beyond qwen3-1.7b: the port on 2 gloo ranks
(``torch_cp_ranks.families``, spawned processes) against the JAX
package's CP step on a 2-device mesh with ``AxisType.Auto`` (a process
of its own, ``--xla_force_host_platform_device_count=2``), one AdamW
step from the same weights:

- reduced gemma2-9b, whose local/global alternation the port's CP step
  once computed over each rank's run alone (the window now rides every
  layer into ``cp_attention``); T 64 (text 10, modality-1 20, text 34),
  an LPT plan with block 8;
- reduced qwen2-vl-7b, the vlm family without ``hidden`` (the loss
  from the forward's logits), on ``make_vlm_batch``'s merged image batch;
- reduced deepseek-moe with the capacity backend dropping pairs
  (``capacity_factor`` 0.5): the aux loss and the drops are the whole
  permuted row's, as in JAX, through the port's all-reduced expert
  histogram and all-gathered expert ids;
- reduced whisper-base, whose decoder self-attention goes through
  ``cp_attention`` while every rank keeps the frame embeddings whole and
  runs the encoder over all of them (the same T 64 input plus
  ``encoder_embeds`` from the same generator);
- reduced zamba2 and reduced xlstm-125m, which the port refuses: the JAX
  CP step runs the recurrence (the SSM; the mLSTM and sLSTM) over the
  permuted order and differs from its own plain step (the test holds
  that difference, which is the reason for the refusal).

Tolerances: loss, ce, aux_loss and grad_norm within 1e-5 relative of the
JAX CP step's (and, for gemma2, qwen2-vl and whisper, of the port's and
JAX's plain steps'); the parameters after the step within 1e-5 of max
|parameter| (AdamW eps 1e-3, for the reason ``test_torch_moe`` gives).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import api as japi
from repro.optim import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch.configs import base
from repro_torch.core import bam
from repro_torch.models import vlm
from repro_torch.parallel import plan_context

from .helpers import REPO
from .test_torch_hybrid import _close_params
from .torch_cp_ranks import run_ranks

REL = 1e-5
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=5, eps=1e-3)
ARCHS = {"gemma2": "gemma2-9b", "qwen2-vl": "qwen2-vl-7b",
         "deepseek-moe": "deepseek-moe-16b", "whisper": "whisper-base",
         "zamba2": "zamba2-2.7b", "xlstm": "xlstm-125m"}
RUNS = {"gemma2": [("allgather", "xla"), ("ring", "bam_kernel")],
        "qwen2-vl": [("allgather", "xla"), ("ring", "xla")],
        "deepseek-moe": [("allgather", "xla"), ("ring", "bam_kernel")],
        "whisper": [("allgather", "xla"), ("ring", "bam_kernel")]}
CP_RUNS = [(n, m, i) for n, runs in RUNS.items() for m, i in runs]


def _cfg(pkg, name):
    cfg = pkg.get_config(ARCHS[name], reduced=True)
    if name == "deepseek-moe":
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, backend="capacity", capacity_factor=0.5))
    return cfg


def _inputs(name):
    """(numpy batch, plan layout) of a case; bits int32."""
    rng = np.random.default_rng(7)
    if name == "qwen2-vl":
        cfg = _cfg(base, name)
        tokens = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
        patches = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
        tb = vlm.make_vlm_batch(torch.from_numpy(tokens),
                                torch.from_numpy(patches), 6, (1, 4, 4),
                                cfg.d_model)
        batch = {k: np.ascontiguousarray(v.numpy()) for k, v in tb.items()}
        batch["labels"] = rng.integers(0, cfg.vocab_size,
                                       (2, 32)).astype(np.int32)
        layout = plan_context(batch["bits"][0], batch["positions"][0], 2,
                              block_size=4, method="lpt").apply(32)
        return batch, layout
    T = 64
    vocab = _cfg(base, name).vocab_size
    bits, pos = bam.build_sample_bits(
        [("text", 0, 10), ("mod", 1, 20), ("text", 0, 34)], T)
    batch = {"tokens": rng.integers(0, vocab, (2, T)).astype(np.int32),
             "labels": rng.integers(0, vocab, (2, T)).astype(np.int32),
             "positions": np.stack([pos] * 2), "bits": np.stack([bits] * 2)}
    if name == "whisper":
        cfg = _cfg(base, name)
        batch["encoder_embeds"] = (rng.normal(size=(
            2, cfg.encdec.encoder_seq, cfg.d_model)) * 0.5).astype(
                np.float32)
    layout = plan_context(bits, pos, 2, block_size=8,
                          method="lpt").apply(T)
    return batch, layout


def _jax_reference(in_path, out_path):
    """In a process with 2 host devices: each case's JAX plain step and
    CP step on a 2-device Auto mesh, one AdamW step from PRNGKey(0)."""
    with open(in_path, "rb") as f:
        spec = pickle.load(f)
    assert len(jax.devices()) == 2, jax.devices()
    mesh = jax.make_mesh((2,), ("cp",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    ocfg = jopt.AdamWConfig(**spec["ocfg"])
    out = {}
    for name, case in spec["cases"].items():
        jcfg = _cfg(jbase, name)
        params = japi.init(jax.random.PRNGKey(0), jcfg)
        jb = {k: jnp.asarray(v.astype(np.uint32) if k == "bits" else v)
              for k, v in case["batch"].items()}
        state = jopt.init(ocfg, params)
        _, _, mp = jax.jit(jsteps.make_train_step(jcfg, ocfg))(
            params, state, jb)
        pc, _, mc = jax.jit(jsteps.make_cp_train_step(
            jcfg, case["layout"], mesh, ocfg))(params, state, jb)
        out[name] = {
            "plain": {k: float(v) for k, v in mp.items()},
            "cp": {k: float(v) for k, v in mc.items()},
            "params": jax.tree.map(np.asarray, pc)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the port's results by rank, the JAX reference's by case): the
    JAX process runs while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("cp_families")
    inputs = {name: _inputs(name) for name in ARCHS}
    spec_path, out_path = tmp / "spec.pkl", tmp / "ref.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump({"ocfg": OCFG, "cases": {
            n: {"batch": b, "layout": lay} for n, (b, lay) in
            inputs.items()}}, f)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_cp_families import _jax_reference; "
            "_jax_reference(sys.argv[2], sys.argv[3])")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, REPO, str(spec_path), str(out_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cases = {}
        for name, (batch, layout) in inputs.items():
            cfg = _cfg(base, name)
            params = japi.init(jax.random.PRNGKey(0), _cfg(jbase, name))
            cases[name] = dict(cfg=cfg, batch=batch, layout=layout,
                               params=jax.tree.map(np.asarray, params),
                               runs=RUNS.get(name, []),
                               refuse=name not in RUNS)
        port = run_ranks(2, "tests.torch_cp_ranks:families",
                         {"ocfg": OCFG, "cases": cases}, tmp, timeout=300)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(out_path, "rb") as f:
        return port, pickle.load(f)


@pytest.mark.parametrize("name,method,impl", CP_RUNS)
def test_cp_step_matches_jax_cp_step(results, name, method, impl):
    port, ref = results
    got = [port[r][(name, method, impl)] for r in (0, 1)]
    want = ref[name]["cp"]
    for key in ("loss", "ce", "aux_loss", "grad_norm"):
        assert got[1][key] == got[0][key], key         # one update
        np.testing.assert_allclose(got[0][key], want.get(key, 0.0),
                                   rtol=REL, atol=0 if want.get(key)
                                   else 1e-12, err_msg=key)
    _close_params(got[0]["params"], ref[name]["params"])
    if name == "deepseek-moe":
        kept = sum(g["drops"][0] for g in got)
        routed = sum(g["drops"][1] for g in got)
        assert 0 < kept < routed                      # pairs were dropped
        assert got[0]["aux_loss"] > 0


@pytest.mark.parametrize("name", ["gemma2", "qwen2-vl", "whisper"])
def test_cp_step_equals_the_plain_steps(results, name):
    """Items 25 and 26 of the port's faults, and Whisper, whose decoder
    would attend over each rank's run alone if its self-attention missed
    ``cp_attention``: the CP step's loss and grad_norm equal the port's
    own plain step's and JAX's plain step's."""
    port, ref = results
    plain_loss, plain_norm = port[0][(name, "plain")]
    for key, want in (("loss", ref[name]["plain"]["loss"]),
                      ("grad_norm", ref[name]["plain"]["grad_norm"])):
        np.testing.assert_allclose(
            {"loss": plain_loss, "grad_norm": plain_norm}[key], want,
            rtol=REL, err_msg=f"port plain {key}")
    for method, impl in RUNS[name]:
        got = port[0][(name, method, impl)]
        np.testing.assert_allclose(got["loss"], plain_loss, rtol=REL)
        np.testing.assert_allclose(got["grad_norm"], plain_norm, rtol=REL)


def test_hybrid_cp_is_refused(results):
    port, ref = results
    for r in (0, 1):
        assert port[r]["zamba2"] is not None
        assert "SSM recurrence" in port[r]["zamba2"]
    # the reason: JAX's CP step runs the SSM over the permuted order and
    # is not its plain step (ROADMAP.md queue 3 records the numbers)
    cp, plain = ref["zamba2"]["cp"], ref["zamba2"]["plain"]
    assert abs(cp["loss"] - plain["loss"]) > 1e-4 * abs(plain["loss"])


def test_xlstm_cp_is_refused(results):
    port, ref = results
    for r in (0, 1):
        assert port[r]["xlstm"] is not None
        assert "recurrence runs along it" in port[r]["xlstm"]
    # the reason: JAX's CP step runs the mLSTM and sLSTM over the permuted
    # order (ROADMAP.md queue 3 records the numbers)
    cp, plain = ref["xlstm"]["cp"], ref["xlstm"]["plain"]
    assert abs(cp["loss"] - plain["loss"]) > 1e-4 * abs(plain["loss"])
    assert abs(cp["grad_norm"] - plain["grad_norm"]) > \
        1e-3 * plain["grad_norm"]


if __name__ == "__main__":
    # The reference's CP and plain steps on each case's input, printed:
    #   XLA_FLAGS=--xla_force_host_platform_device_count=2 \
    #   JAX_PLATFORMS=cpu PYTHONPATH=src python -m tests.test_torch_cp_families
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        spec, out = os.path.join(tmp, "spec.pkl"), os.path.join(tmp, "ref.pkl")
        with open(spec, "wb") as f:
            pickle.dump({"ocfg": OCFG, "cases": {
                n: dict(zip(("batch", "layout"), _inputs(n)))
                for n in ARCHS}}, f)
        _jax_reference(spec, out)
        with open(out, "rb") as f:
            ref = pickle.load(f)
    for name, r in ref.items():
        print(f"{name}: CP loss {r['cp']['loss']:.7f} grad_norm "
              f"{r['cp']['grad_norm']:.6f}; plain loss "
              f"{r['plain']['loss']:.7f} grad_norm "
              f"{r['plain']['grad_norm']:.6f}")
