"""The port's BAM (``repro_torch.core.bam``) against ``repro.core.bam``:
mask expansion (torch and numpy), block-map steps and sample bits agree
element for element over the cases of tests/test_bam.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bam as jbam
from repro_torch.core import bam as tbam
from tests.test_bam import random_segments


def _sample(seed, T):
    segs = random_segments(np.random.default_rng(seed), T)
    jb, jp = jbam.build_sample_bits(segs, T)
    tb, tp = tbam.build_sample_bits(segs, T)
    return segs, (jb, jp), (tb, tp)


@pytest.mark.parametrize("seed", range(8))
def test_build_sample_bits_equal(seed):
    _, (jb, jp), (tb, tp) = _sample(seed, 48)
    assert tb.dtype == np.int32
    np.testing.assert_array_equal(tb.astype(np.int64), jb.astype(np.int64))
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("window", [0, 5])
def test_allowed_mask_equal(seed, window):
    _, (jb, jp), (tb, tp) = _sample(seed, 48)
    want = np.asarray(jbam.allowed_mask(
        jnp.asarray(jb)[None], jnp.asarray(jb)[None],
        jnp.asarray(jp)[None], jnp.asarray(jp)[None], window))
    tbt, tpt = torch.from_numpy(tb)[None], torch.from_numpy(tp)[None]
    got = tbam.allowed_mask(tbt, tbt, tpt, tpt, window).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tbam.allowed_mask_np(tb[None], tb[None], tp[None], tp[None], window),
        want)


def test_fields_and_tokens_equal():
    for args in [(0b101, 3, 7), (1, 0, 0), (0xFFFF, 127, 255)]:
        assert tbam.encode(*args) == jbam.encode(*args)
    assert tbam.text_token([1, 2], 3) == jbam.text_token([1, 2], 3)
    assert tbam.modality_token(2, 5) == jbam.modality_token(2, 5)
    b = torch.tensor([tbam.encode(0b101, 3, 7)], dtype=torch.int32)
    assert int(tbam.attends_set(b)) == 0b101
    assert int(tbam.own_modality(b)) == 3
    assert int(tbam.instance_id(b)) == 7
    causal = tbam.causal_bits(2, 5, device="cpu")
    assert causal.dtype == torch.int32
    np.testing.assert_array_equal(causal.numpy(),
                                  np.asarray(jbam.causal_bits(2, 5)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbam.causal_bits(2, 5)           # the default device is the card


def test_key_modality_outside_attends_set_never_allowed():
    """A key whose modality field is >= 16 lies outside every 16-bit
    attends-set: JAX's shift gives 0, and so must the port's guard."""
    q = np.array([[tbam.encode(0xFFFF, 0)]], np.int32)
    k = np.array([[tbam.encode(1, 16), tbam.encode(1, 40)]], np.int32)
    pos = np.zeros((1, 1), np.int32)
    kpos = np.zeros((1, 2), np.int32)
    want = np.asarray(jbam.allowed_mask(
        jnp.asarray(q, jnp.uint32), jnp.asarray(k, jnp.uint32),
        jnp.asarray(pos), jnp.asarray(kpos)))
    got = tbam.allowed_mask(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(pos), torch.from_numpy(kpos))
    assert not want.any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("window", [0, 5])
def test_build_block_map_equal(seed, window):
    _, (jb, jp), (tb, tp) = _sample(seed + 300, 48)
    for bq, bk in [(8, 16), (16, 8), (1, 16)]:
        want = jbam.build_block_map(jb, jb, jp, jp, bq, bk, window)
        got = tbam.build_block_map(tb, tb, tp, tp, bq, bk, window)
        assert got.q_steps == want.q_steps
        assert got.k_steps == want.k_steps
        assert (got.nq, got.nk, got.n_steps) == (want.nq, want.nk,
                                                  want.n_steps)
        assert got.skip_fraction == want.skip_fraction
        for a, b in zip(got.arrays("k"), want.arrays("k")):
            np.testing.assert_array_equal(a, b)


def test_block_map_batch_union_equal():
    b0, p0 = tbam.build_sample_bits([("text", 0, 16)], 32)
    b1, p1 = tbam.build_sample_bits(
        [("text", 0, 8), ("mod", 1, 8), ("text", 0, 16)], 32)
    bits, pos = np.stack([b0, b1]), np.stack([p0, p1])
    got = tbam.build_block_map(bits, bits, pos, pos, 8, 8)
    want = jbam.build_block_map(bits.astype(np.uint32), bits.astype(np.uint32),
                                pos, pos, 8, 8)
    assert got.q_steps == want.q_steps and got.k_steps == want.k_steps


def test_repeat_kv_matches():
    k = np.random.default_rng(0).normal(size=(2, 3, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tbam.repeat_kv(torch.from_numpy(k), 3).numpy(),
        np.asarray(jbam.repeat_kv(jnp.asarray(k), 3)))
