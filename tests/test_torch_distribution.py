"""The port's token distribution for context parallelism against the JAX
package's, element by element (numpy on both sides): per-token and
per-block workloads, every planner, ``plan_tokens``, ``graham_bound``,
``plan_permutation`` (divisible and not), ``ContextPlan`` and
``plan_context``, ``apply_plan``, ``simulate_rank_workloads`` and the
serving side's ``plan_page_owners``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bam as jbam
from repro.core import context_parallel as jcp
from repro.core import distribution as jdist
from repro.data.synthetic import random_multimodal_bits as j_random_bits
from repro.parallel import plan_context as j_plan_context
from repro.serving.paged_cache import plan_page_owners as j_page_owners
from repro_torch.core import bam
from repro_torch.core import context_parallel as cp
from repro_torch.core import distribution as dist
from repro_torch.data.synthetic import random_multimodal_bits
from repro_torch.parallel import ContextPlan, plan_context
from repro_torch.serving.paged_cache import plan_page_owners

LAYOUTS = [(256, "ee", 0), (256, "ep", 1), (300, "mp", 2), (512, "ee", 3)]


def _layout(T, mode, seed):
    bits, pos = random_multimodal_bits(T, mode, seed=seed)
    jbits, jpos = j_random_bits(T, mode, seed=seed)
    np.testing.assert_array_equal(bits, jbits.astype(np.int32))
    np.testing.assert_array_equal(pos, jpos)
    return bits, pos


@pytest.mark.parametrize("T,mode,seed", LAYOUTS)
@pytest.mark.parametrize("window", [0, 48])
def test_workloads_match_jax(T, mode, seed, window):
    bits, pos = _layout(T, mode, seed)
    W = bam.token_workload(bits, pos, window)
    np.testing.assert_array_equal(
        W, jbam.token_workload(bits.astype(np.uint32), pos, window))
    # the row-sums of the dense mask, as the definition says
    dense = bam.allowed_mask_np(bits, bits, pos, pos, window).sum(axis=1)
    np.testing.assert_array_equal(W, dense)
    for block in (16, 64, 100):
        np.testing.assert_array_equal(
            bam.block_workload(bits, pos, block, window),
            jbam.block_workload(bits.astype(np.uint32), pos, block, window))


@pytest.mark.parametrize("method", sorted(dist.PLANNERS))
@pytest.mark.parametrize("G", [2, 3, 4])
def test_planners_match_jax(method, G):
    bits, pos = _layout(256, "ee", 5)
    block = 32 if method == "ilp" else 16       # keep the exact search small
    W = bam.block_workload(bits, pos, block)
    got = dist.PLANNERS[method](W, G, block)
    want = jdist.PLANNERS[method](W, G, block)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.loads, want.loads)
    assert got.assignment.dtype == np.int32
    assert (got.makespan, got.imbalance) == (want.makespan, want.imbalance)
    for a, b in zip(got.rank_token_slices(), want.rank_token_slices()):
        np.testing.assert_array_equal(a, b)
    assert dist.graham_bound(W, G) == jdist.graham_bound(W, G)
    if method == "lpt":
        assert got.makespan <= dist.graham_bound(W, G)


@pytest.mark.parametrize("T,mode,seed", LAYOUTS)
def test_plan_tokens_and_simulated_workloads_match_jax(T, mode, seed):
    bits, pos = _layout(T, mode, seed)
    for method in ("lpt", "zigzag", "ring", "random"):
        got = dist.plan_tokens(bits, pos, 4, block_size=32, method=method)
        want = jdist.plan_tokens(bits.astype(np.uint32), pos, 4,
                                 block_size=32, method=method)
        np.testing.assert_array_equal(got.assignment, want.assignment)
        loads = cp.simulate_rank_workloads(got, bits, pos)
        np.testing.assert_array_equal(
            loads, jcp.simulate_rank_workloads(want, bits.astype(np.uint32),
                                               pos))
        np.testing.assert_allclose(loads.sum(),
                                   bam.token_workload(bits, pos).sum())


@pytest.mark.parametrize("T,G,bs,method", [
    (64, 4, 8, "lpt"), (64, 2, 4, "zigzag"),       # divisible
    (30, 4, 4, "lpt"), (37, 3, 8, "ring"), (50, 4, 16, "random")])
def test_plan_permutation_matches_jax(T, G, bs, method):
    bits, pos = bam.build_sample_bits(
        [("text", 0, T // 3), ("mod", 1, T // 3),
         ("text", 0, T - 2 * (T // 3))], T)
    plan = dist.plan_tokens(bits, pos, G, block_size=bs, method=method)
    jplan = jdist.plan_tokens(bits.astype(np.uint32), pos, G,
                              block_size=bs, method=method)
    perm = cp.plan_permutation(plan, T)
    np.testing.assert_array_equal(perm, jcp.plan_permutation(jplan, T))
    assert sorted(perm.tolist()) == list(range(T))
    inv = cp.invert_perm(perm)
    np.testing.assert_array_equal(inv, jcp.invert_perm(perm))
    np.testing.assert_array_equal(perm[inv], np.arange(T))
    with pytest.raises(ValueError, match="covers"):
        cp.plan_permutation(plan, len(plan.assignment) * bs + 1)


@pytest.mark.parametrize("method", ["lpt", "zigzag", "ring", "auto"])
def test_context_plan_matches_jax(method):
    bits, pos = _layout(256, "ep", 7)
    got = plan_context(bits, pos, 4, block_size=32, method=method)
    want = j_plan_context(bits.astype(np.uint32), pos, 4, block_size=32,
                          method=method)
    assert isinstance(got, ContextPlan)
    assert (got.method, got.num_ranks, got.block_size, got.assignment,
            got.loads) == (want.method, want.num_ranks, want.block_size,
                           want.assignment, want.loads)
    assert (got.makespan, got.imbalance) == (want.makespan, want.imbalance)
    for a, b in zip(got.rank_token_slices(), want.rank_token_slices()):
        np.testing.assert_array_equal(a, b)
    assert ContextPlan.from_core(got.core_plan(), got.method) == got
    for T in (256, 250):
        lay, jlay = got.apply(T), want.apply(T)
        assert set(lay) == set(jlay)
        for key in lay:
            np.testing.assert_array_equal(lay[key], jlay[key])
        for ps in (4, 16):
            np.testing.assert_array_equal(plan_page_owners(lay, ps),
                                          j_page_owners(jlay, ps))
    with pytest.raises(ValueError, match="unknown balancer"):
        plan_context(bits, pos, 4, method="greedy")
    with pytest.raises(ValueError, match="unknown balancer"):
        ContextPlan("greedy", 1, 4, (0,), (1.0,))


def test_apply_plan_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 3)).astype(np.float32)
    b = rng.integers(0, 9, size=(2, 12)).astype(np.int32)
    perm = rng.permutation(12)
    got = cp.apply_plan({"x": torch.from_numpy(x), "b": torch.from_numpy(b)},
                        perm)
    want = jcp.apply_plan({"x": jnp.asarray(x), "b": jnp.asarray(b)}, perm)
    for key in ("x", "b"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    tup = cp.apply_plan((torch.from_numpy(x),), perm, axis=1)
    assert isinstance(tup, tuple)
    np.testing.assert_array_equal(tup[0].numpy(), x[:, perm])
