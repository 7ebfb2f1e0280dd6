"""The port's ServingEngine on the CPU against the JAX engine: identical
greedy tokens for text and multimodal prompts on the reduced paper LLM,
through the plain paths (xla <-> xla) and the kernel paths (the port's
plain K1/K4 <-> JAX's interpret-mode Pallas kernels). Also continuous
against sequential batching, page reuse with scrubbed metadata, and the
engine's refusals."""
import numpy as np
import pytest
import torch

import jax

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.paper_mllm import llm_config as j_llm_config
from repro.models import api as japi
from repro.parallel import plan_context as j_plan_context
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_mllm import llm_config
from repro_torch.core import bam
from repro_torch.parallel import plan_context
from repro_torch.serving import (InfeasibleRequest, PageTable,
                                 ServingEngine, init_paged_cache)

PATHS = {"plain": (("xla", "xla"), ("xla", "xla")),
         "kernel": (("bam_interpret", "interpret"), ("bam_kernel", "kernel"))}


@pytest.fixture(scope="module")
def weights():
    jcfg = j_llm_config("M", reduced=True)
    params = japi.init(jax.random.PRNGKey(0), jcfg)
    cfg = llm_config("M", reduced=True)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, params, cfg, model


def _requests(kind):
    rng = np.random.default_rng(3)
    if kind == "text":
        return [dict(tokens=rng.integers(1, 512, size=n), max_new_tokens=4)
                for n in (7, 12, 5)]
    bits, pos = bam.build_sample_bits(
        [("text", 0, 4), ("mod", 1, 8), ("text", 0, 4)], 16)
    return [dict(tokens=rng.integers(1, 512, size=16), bits=bits,
                 positions=pos, gen_bits=bam.text_token((1,)),
                 max_new_tokens=4),
            dict(tokens=rng.integers(1, 512, size=9), max_new_tokens=4)]


def _engine(model, cfg, attn, impl, **kw):
    kw = {"num_pages": 24, "page_size": 8, "max_batch": 2, **kw}
    return ServingEngine(model, cfg.replace(attn_impl=impl), attn=attn,
                         device="cpu", **kw)


def _run(eng, reqs):
    rids = [eng.submit(**r) for r in reqs]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("kind", ["text", "multimodal"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_matches_jax_engine(weights, kind, path):
    jcfg, params, cfg, model = weights
    (j_impl, j_attn), (t_impl, t_attn) = PATHS[path]
    reqs = _requests(kind)
    jeng = JServingEngine(params, jcfg.replace(attn_impl=j_impl),
                          num_pages=24, page_size=8, max_batch=2, attn=j_attn)
    want = _run(jeng, [dict(r, bits=None if r.get("bits") is None
                            else r["bits"].astype(np.uint32)) for r in reqs])
    got = _run(_engine(model, cfg, t_attn, t_impl), reqs)
    assert got == want


@pytest.mark.parametrize("path", sorted(PATHS))
def test_plan_prefill_matches_jax_and_planless(weights, path):
    """Prompts prefilled in a 4-rank LPT plan's layout: the same greedy
    tokens as the JAX engine with the same plan and as the plan-less
    run, and the pages record their CP ranks."""
    jcfg, params, cfg, model = weights
    (j_impl, j_attn), (t_impl, t_attn) = PATHS[path]
    reqs = _requests("multimodal") + _requests("text")[:1]
    plans, jplans = [], []
    for r in reqs:
        T = len(r["tokens"])
        Tp = -(-T // 8) * 8                    # the page-padded prompt
        bits = np.zeros(Tp, np.int32)
        bits[:T] = r["bits"] if r.get("bits") is not None \
            else bam.text_token()
        pos = np.full(Tp, -1, np.int32)
        pos[:T] = r["positions"] if r.get("positions") is not None \
            else np.arange(T)
        plans.append(plan_context(bits, pos, 4, block_size=4))
        jplans.append(j_plan_context(bits.astype(np.uint32), pos, 4,
                                     block_size=4))
        assert plans[-1].assignment == jplans[-1].assignment
    jeng = JServingEngine(params, jcfg.replace(attn_impl=j_impl),
                          num_pages=24, page_size=8, max_batch=2, attn=j_attn)
    want = _run(jeng, [dict(r, plan=jp, bits=None if r.get("bits") is None
                            else r["bits"].astype(np.uint32))
                       for r, jp in zip(reqs, jplans)])
    eng = _engine(model, cfg, t_attn, t_impl)
    rids = [eng.submit(**r, plan=pl) for r, pl in zip(reqs, plans)]
    owners = eng.table.page_owner.copy()
    eng.step()                                 # admits and prefills two
    owners_after = eng.table.page_owner.copy()
    got = eng.run()
    got = [got[r] for r in rids]
    planless = _run(_engine(model, cfg, t_attn, t_impl), reqs)
    assert got == want == planless
    assert (owners == -1).all()
    # 16 slots over 4 ranks, 8-slot pages: ranks 0 and 2 own the pages
    assert sorted(set(owners_after.tolist()) - {-1}) == [0, 2]
    assert (eng.table.page_owner == -1).all()  # freed pages forget


@pytest.mark.parametrize("cfg_kw", [
    dict(attn_softcap=10.0),
    dict(decode_kv_replicate=4),
    dict(sliding_window=6, local_global_pattern=2, attn_softcap=10.0),
])
def test_engine_matches_jax_engine_variants(cfg_kw):
    """Softcap, KV-head replication in the cache, and per-layer sliding
    windows (gemma2-style alternation) through the port's kernel path,
    against the JAX engine, on tests/test_serving.py's tiny config."""
    base = dict(name="tiny-serve", family="dense", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                dtype="float32", remat=False, seq_shard_activations=False,
                **cfg_kw)
    jcfg, cfg = JModelConfig(**base), ModelConfig(**base)
    params = japi.init(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.default_rng(3)
    reqs = [dict(tokens=rng.integers(1, 64, size=n), max_new_tokens=4)
            for n in (7, 12)]
    jeng = JServingEngine(params, jcfg, num_pages=24, page_size=8,
                          max_batch=3, attn="xla")
    want = _run(jeng, reqs)
    got = _run(_engine(model, cfg, "kernel", "bam_kernel", max_batch=3),
               reqs)
    assert got == want


@pytest.mark.parametrize("attn,impl", [("xla", "xla"), ("kernel", "bam_kernel")])
def test_continuous_equals_sequential(weights, attn, impl):
    """A request's tokens do not depend on which requests share its
    batch: one engine with 3 rows == one engine per request."""
    _, _, cfg, model = weights
    reqs = _requests("text") + _requests("multimodal")
    batched = _run(_engine(model, cfg, attn, impl, max_batch=3), reqs)
    solo = [_run(_engine(model, cfg, attn, impl, max_batch=1), [r])[0]
            for r in reqs]
    assert batched == solo


def test_page_reuse_scrubs_metadata(weights):
    _, _, cfg, model = weights
    req = _requests("multimodal")[0]
    eng = _engine(model, cfg, "kernel", "bam_kernel", num_pages=8)
    first = _run(eng, [req])
    assert eng.table.num_free == 7
    assert int(eng.cache["bits"].abs().sum()) == 0    # device scrub
    assert (eng.cache["pos"][1:] == -1).all()
    second = _run(eng, [req])                         # on recycled pages
    fresh = _run(_engine(model, cfg, "kernel", "bam_kernel", num_pages=8),
                 [req])
    assert first == second == fresh
    assert eng.decode_ticks > 0 and eng.prefill_seconds > 0


def test_engine_refusals(weights):
    _, _, cfg, model = weights
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, cfg)                     # default device
    with pytest.raises(ValueError, match="interpret"):
        ServingEngine(model, cfg, attn="interpret", device="cpu")
    eng = ServingEngine(model, cfg, num_pages=4, page_size=4, max_batch=2,
                        device="cpu")
    with pytest.raises(InfeasibleRequest) as e:
        eng.submit(np.arange(8), max_new_tokens=15)
    assert e.value.needed_pages == 6 and e.value.capacity == 3
    assert not eng.queue and not eng.requests
    with pytest.raises(TypeError, match="ContextPlan"):
        eng.submit(np.arange(4), plan=object())
    rid = eng.submit(np.arange(6), max_new_tokens=4)
    assert rid == 0 and len(eng.run()[rid]) == 4
    # a ContextPlan prefill runs (tokens checked in
    # test_plan_prefill_matches_jax_and_planless)
    bits, pos = bam.build_sample_bits([("text", 0, 8)], 8)
    rid = eng.submit(np.arange(8), max_new_tokens=2,
                     plan=plan_context(bits, pos, 2, block_size=4))
    assert len(eng.run()[rid]) == 2


def test_paged_cache_guards():
    table = PageTable(4, 4)
    table.alloc(0, 12)
    with pytest.raises(RuntimeError, match="exhausted"):
        table.alloc(1, 4)
    with pytest.raises(IndexError):
        table.coords(0, [12])
    table.free(0)
    assert table.num_free == 3
    cfg = llm_config("M", reduced=True).replace(decode_kv_replicate=4)
    cache = init_paged_cache(cfg, 4, 4, device="cpu")
    assert cache["k"].shape == (2, 4, 4, 4, 64)
    assert cache["bits"].dtype == torch.int32 and int(cache["bits"].sum()) == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_cache(cfg, 4, 4)
