"""The port's context parallelism on the CPU against the JAX package.

- K1's stats mode (its plain version, through the wrapper and the op)
  against the JAX op ``bam_attention_stats`` on the interpret-mode Pallas
  kernel, atol 1e-5 in f32, with GQA, softcap, window, ragged lengths,
  and exact (m, l, acc) = (-1e30, 0, 0) on rows with no key in the chunk.
- ``cp_attention`` (allgather and ring, impl xla and bam_kernel) on 1, 2
  and 4 gloo ranks, each rank its own process (``torch_cp_ranks``),
  against JAX's ``cp_reference`` and ``jax.grad`` of it at atol 2e-4
  (the JAX package's own CP gradient tolerance).
- 3 steps of ``make_cp_train_step`` on reduced qwen3-1.7b through the
  weight bridge at 1 (in this process), 2 and 4 ranks against JAX's
  ``make_cp_train_step`` on a 1-device mesh with Auto axes and the
  unpermuted ``make_train_step``: loss rel 1e-5, grad_norm rel 1e-4.
- The step's refusals, and that no CP Function saves a tensor of the
  size of the [B,H,Tq,Tk] logits.

Every JAX mesh is built with ``AxisType.Auto``: jax 0.9's ``make_mesh``
defaults to Explicit axes, under which the reference CP step refuses the
contraction of a sharded dimension.
"""
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core import context_parallel as jcp
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.optim import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core import bam
from repro_torch.core import context_parallel as cp
from repro_torch.kernels import ops
from repro_torch.kernels.bam_attention import bam_flash_attention
from repro_torch.models import api
from repro_torch.optim import optimizer as opt
from repro_torch.parallel import plan_context
from repro_torch.training import steps

from .torch_cp_ranks import run_ranks

CASES = [(m, i) for m in ("allgather", "ring") for i in ("xla", "bam_kernel")]
SETTINGS = {"plain": (0.0, 0), "softcap-window": (20.0, 24)}
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=5)


def _auto_mesh():
    return jax.make_mesh((1,), ("cp",),
                         axis_types=(jax.sharding.AxisType.Auto,))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A world-size-1 gloo group in this process, for the single-rank
    checks."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# K1 stats mode
# ---------------------------------------------------------------------------

def _chunk_case(Tq, Tk, H, Hkv, hd, seed=0):
    """q rows from the front of a text/image/text sequence against a
    later chunk of its keys: causal text rows see nothing there, image
    rows see their own stream."""
    T = Tq + Tk
    bits, pos = bam.build_sample_bits(
        [("text", 0, Tq // 2), ("mod", 1, T // 2),
         ("text", 0, T - Tq // 2 - T // 2)], T)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, Tq, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(2, Tk, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    qb, kb = (np.stack([b, b]) for b in (bits[:Tq], bits[Tq:]))
    qp, kp = (np.stack([p, p]) for p in (pos[:Tq], pos[Tq:]))
    return q, k, v, qb, kb, qp, kp


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 12),
                                            (30.0, 12)])
@pytest.mark.parametrize("Tq,Tk", [(32, 48), (37, 45)])
def test_k1_stats_plain_matches_pallas_interpret(softcap, window, Tq, Tk):
    q, k, v, qb, kb, qp, kp = _chunk_case(Tq, Tk, H=4, Hkv=2, hd=32)
    want = jops.bam_attention_stats(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(qb.astype(np.uint32)),
        jnp.asarray(kb.astype(np.uint32)), jnp.asarray(qp), jnp.asarray(kp),
        softcap=softcap, window=window, impl="bam_interpret", block_q=16,
        block_k=16)
    want = [np.asarray(a) for a in want]
    args = [torch.from_numpy(a) for a in (q, k, v, qb, kb, qp, kp)]
    got_op = ops.bam_attention_stats(*args, softcap=softcap, window=window)
    got = bam_flash_attention(*args, softcap=softcap, window=window,
                              return_mode="stats")
    empty = want[2] == 0
    assert empty.any() and (~empty).any()          # both kinds of row
    for g, g_op, w, name in zip(got, got_op, want, ("acc", "m", "l")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=name)
        assert torch.equal(g, g_op), name
    acc, m, l = (g.numpy() for g in got)
    # the exact conventions the cross-chunk combine relies on
    assert (m[empty] == np.float32(-1e30)).all() and (l[empty] == 0).all()
    assert (acc[empty] == 0).all()
    assert (want[1][empty] == np.float32(-1e30)).all()
    assert (want[0][empty] == 0).all()
    assert bam_flash_attention.stats_launches == 0   # the CPU never launches
    for a in args[:3]:
        a.requires_grad_()
    assert not any(t.requires_grad for t in ops.bam_attention_stats(*args))


def test_stats_combine_equals_one_pass():
    """Chunk stats combined with the CP combine give the single-pass
    forward's out and lse (the K1 `residual` mode's plain version)."""
    q, k, v, qb, kb, qp, kp = _chunk_case(24, 40, H=4, Hkv=2, hd=32, seed=3)
    kb_all = np.concatenate([qb, kb], 1)
    kp_all = np.concatenate([qp, kp], 1)
    rng = np.random.default_rng(4)
    k_all = np.concatenate(
        [rng.normal(size=(2, 24, 2, 32)).astype(np.float32), k], 1)
    v_all = np.concatenate(
        [rng.normal(size=(2, 24, 2, 32)).astype(np.float32), v], 1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    parts = [ops.bam_attention_stats(t(q), t(k_all[:, s]), t(v_all[:, s]),
                                     t(qb), t(kb_all[:, s]), t(qp),
                                     t(kp_all[:, s]))
             for s in (slice(0, 24), slice(24, 40), slice(40, 64))]
    acc, m, l = parts[0]
    for part in parts[1:]:
        acc, m, l = cp._combine_stats(acc, m, l, *part)
    out, lse = bam_flash_attention(t(q), t(k_all), t(v_all), t(qb),
                                   t(kb_all), t(qp), t(kp_all),
                                   return_mode="residual")
    np.testing.assert_allclose(cp._finish(acc, m, l, torch.float32).numpy(),
                               out.numpy(), atol=1e-5)
    np.testing.assert_allclose(cp._lse_from_stats(m, l).numpy(),
                               lse.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# cp_attention on 1, 2 and 4 ranks
# ---------------------------------------------------------------------------

def _attention_inputs(G, softcap, window):
    """Global inputs in a G-rank LPT plan's layout, and a cotangent w."""
    from repro_torch.data.synthetic import random_multimodal_bits
    B, T, H, Hkv, hd = 2, 64, 4, 2, 16
    bits, pos = random_multimodal_bits(T, "ee", seed=G)
    perm = plan_context(bits, pos, G, block_size=8).apply(T)["perm"]
    rng = np.random.default_rng(G)
    arr = {"q": rng.normal(size=(B, T, H, hd)),
           "k": rng.normal(size=(B, T, Hkv, hd)),
           "v": rng.normal(size=(B, T, Hkv, hd)),
           "w": rng.normal(size=(B, T, H, hd))}
    arr = {n: a.astype(np.float32) for n, a in arr.items()}
    arr["bits"] = np.stack([bits[perm]] * B)
    arr["pos"] = np.stack([pos[perm]] * B)
    return dict(arr, cases=CASES, softcap=softcap, window=window)


@pytest.fixture(scope="module")
def cache():
    """Results shared by the parametrised cases of one spawned run."""
    return {}


def _attention_results(cache, world, setting, tmp_path_factory):
    """Ranks' outputs and gradients, assembled along the token axis, and
    JAX's reference, cached per (world, setting)."""
    key = ("attention", world, setting)
    if key not in cache:
        softcap, window = SETTINGS[setting]
        payload = _attention_inputs(world, softcap, window)
        by_rank = run_ranks(world, "attention", payload,
                            tmp_path_factory.mktemp("ranks"))
        got = {case: [np.concatenate([by_rank[r][case][i]
                                      for r in range(world)], axis=1)
                      for i in range(4)] for case in CASES}
        j = {n: jnp.asarray(payload[n]) for n in ("q", "k", "v", "w")}
        jb = jnp.asarray(payload["bits"].astype(np.uint32))
        jp = jnp.asarray(payload["pos"])

        def ref(q, k, v):
            return jcp.cp_reference(q, k, v, jb, jb, jp, jp,
                                    softcap=softcap, window=window)
        want = [np.asarray(ref(j["q"], j["k"], j["v"]))] + [
            np.asarray(g) for g in jax.grad(
                lambda q, k, v: jnp.sum(ref(q, k, v) * j["w"]),
                (0, 1, 2))(j["q"], j["k"], j["v"])]
        cache[key] = (got, want)
    return cache[key]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("method,impl", CASES)
@pytest.mark.parametrize("world", [1, 2, 4])
def test_cp_attention_matches_jax_reference(world, method, impl, setting,
                                            cache, tmp_path_factory):
    got, want = _attention_results(cache, world, setting, tmp_path_factory)
    for g, w, name in zip(got[(method, impl)], want, ("out", "dq", "dk",
                                                      "dv")):
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("method", ["allgather", "ring"])
@pytest.mark.parametrize("impl", ["xla", "bam_kernel"])
def test_cp_functions_save_no_logits_sized_tensor(group, method, impl):
    p = _attention_inputs(1, 0.0, 0)
    q, k, v = (torch.from_numpy(p[n]).requires_grad_() for n in "qkv")
    bits, pos = torch.from_numpy(p["bits"]), torch.from_numpy(p["pos"])
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = cp.cp_attention(group, q, k, v, bits, bits, pos, pos,
                              method=method, impl=impl)
    B, T, H, _ = q.shape
    assert len(saved) == 9, saved       # q, k, v, 2 bits, 2 pos, out, lse
    assert max(int(np.prod(s)) for s in saved) < B * H * T * T, saved
    out.sum().backward()
    assert q.grad is not None and k.grad is not None


def test_cp_attention_refusals(group):
    p = _attention_inputs(1, 0.0, 0)
    q, k, v = (torch.from_numpy(p[n]) for n in "qkv")
    bits, pos = torch.from_numpy(p["bits"]), torch.from_numpy(p["pos"])
    with pytest.raises(TypeError, match="ProcessGroup"):
        cp.cp_attention(object(), q, k, v, bits, bits, pos, pos)
    with pytest.raises(ValueError, match="unknown CP method"):
        cp.cp_attention(group, q, k, v, bits, bits, pos, pos, method="x")
    with pytest.raises(ValueError, match="impl"):
        cp.cp_attention(group, q, k, v, bits, bits, pos, pos,
                        impl="bam_interpret")


# ---------------------------------------------------------------------------
# The CP train step
# ---------------------------------------------------------------------------

T_TRAIN, B_TRAIN = 32, 2


def _train_setup():
    jcfg = j_get_config("qwen3-1.7b", reduced=True)
    params = japi.init(jax.random.PRNGKey(0), jcfg)
    bits, pos = bam.build_sample_bits(
        [("text", 0, 8), ("mod", 1, 8), ("text", 0, 16)], T_TRAIN)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        batches.append({
            "tokens": rng.integers(0, jcfg.vocab_size,
                                   (B_TRAIN, T_TRAIN)).astype(np.int32),
            "labels": rng.integers(0, jcfg.vocab_size,
                                   (B_TRAIN, T_TRAIN)).astype(np.int32),
            "positions": np.stack([pos] * B_TRAIN),
            "bits": np.stack([bits] * B_TRAIN),
            "valid": np.stack([bits != 0] * B_TRAIN)})
    return jcfg, params, bits, pos, batches


def _jax_runs(step, params, batches):
    state = jopt.init(jopt.AdamWConfig(**OCFG), params)
    out = []
    for b in batches:
        jb = {k: jnp.asarray(x.astype(np.uint32) if k == "bits" else x)
              for k, x in b.items()}
        params, state, met = step(params, state, jb)
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


def _jax_train(cache, plan_ranks):
    """JAX's runs, cached: the setup, the plain step's run, and the CP
    step's run per method on a ``plan_ranks``-rank plan."""
    if "setup" not in cache:
        jcfg, params, bits, pos, batches = _train_setup()
        ocfg = jopt.AdamWConfig(**OCFG)
        plain = _jax_runs(jax.jit(jsteps.make_train_step(jcfg, ocfg)),
                          params, batches)
        cache["setup"] = (jcfg, params, bits, pos, batches, plain)
    jcfg, params, bits, pos, batches, plain = cache["setup"]
    if ("jax", plan_ranks) not in cache:
        layout = plan_context(bits, pos, plan_ranks, block_size=4,
                              method="lpt").apply(T_TRAIN)
        j_cp = {}
        for method in ("allgather", "ring"):
            with warnings.catch_warnings():      # the 1-device mesh
                warnings.simplefilter("ignore", UserWarning)
                step = jsteps.make_cp_train_step(
                    jcfg, layout, _auto_mesh(), jopt.AdamWConfig(**OCFG),
                    method=method)
            j_cp[method] = _jax_runs(jax.jit(step), params, batches)
        cache[("jax", plan_ranks)] = (layout, j_cp)
    return (params, batches, plain) + cache[("jax", plan_ranks)]


def _train_results(cache, world, tmp_path_factory):
    """(port's runs by (method, impl), JAX CP step's runs by method, JAX
    plain step's run) for a plan of max(world, 2) ranks."""
    if ("train", world) not in cache:
        params, batches, j_plain, layout, j_cp = _jax_train(cache,
                                                            max(world, 2))
        np_params = jax.tree.map(np.asarray, params)
        if world == 1:
            got = _torch_train_in_process(np_params, layout, batches)
        else:
            payload = dict(params=np_params, layout=layout, batches=batches,
                           ocfg=OCFG, cases=CASES)
            by_rank = run_ranks(world, "train", payload,
                                tmp_path_factory.mktemp("ranks"))
            for r in range(1, world):           # every rank saw the same
                assert by_rank[r] == by_rank[0]
            got = by_rank[0]
        cache[("train", world)] = (got, j_cp, j_plain)
    return cache[("train", world)]


def _torch_train_in_process(np_params, layout, batches):
    """World size 1: the CP step in this process, on a 2-rank plan (exact
    but unbalanced, and the step says so)."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    ocfg = opt.AdamWConfig(**OCFG)
    res = {}
    for method, impl in CASES:
        model = bridge.from_jax_params(np_params, cfg, device="cpu")
        model.requires_grad_(True)
        state = opt.init(ocfg, dict(model.named_parameters()))
        with pytest.warns(UserWarning, match="balanced for 2 ranks"):
            step = steps.make_cp_train_step(
                cfg.replace(attn_impl=impl), layout, dist.group.WORLD, ocfg,
                method=method)
        hist = []
        for b in batches:
            model, state, met = step(
                model, state, {k: torch.from_numpy(x) for k, x in b.items()})
            hist.append((float(met["loss"]), float(met["grad_norm"])))
        res[(method, impl)] = hist
    return res


@pytest.mark.parametrize("method,impl", CASES)
@pytest.mark.parametrize("world", [1, 2, 4])
def test_cp_train_steps_match_jax(world, method, impl, group, cache,
                                  tmp_path_factory):
    got, j_cp, j_plain = _train_results(cache, world, tmp_path_factory)
    for i, (lt, gt) in enumerate(got[(method, impl)]):
        for lj, gj in (j_cp[method][i], j_plain[i]):
            np.testing.assert_allclose(lt, lj, rtol=1e-5,
                                       err_msg=f"loss, step {i}")
            np.testing.assert_allclose(gt, gj, rtol=1e-4,
                                       err_msg=f"grad_norm, step {i}")
    if world > 1:
        assert "not divisible" in got["indivisible"]


def test_cp_train_step_refusals(group):
    cfg = get_config("qwen3-1.7b", reduced=True)
    _, _, bits, pos, batches = _train_setup()
    layout = plan_context(bits, pos, 1, block_size=4).apply(T_TRAIN)
    with pytest.raises(TypeError, match="ProcessGroup"):
        steps.make_cp_train_step(cfg, layout, object())
    step = steps.make_cp_train_step(cfg, layout, group)
    model = api.init(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(x) for k, x in batches[0].items()
             if k != "bits"}
    with pytest.raises(ValueError, match=r"batch\['bits'\]"):
        step(model, opt.init(opt.AdamWConfig(), {}), batch)

