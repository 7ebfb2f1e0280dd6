"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's ``repro.checkpoint`` on the CPU.

The manifest's MessagePack subset is byte-equal to ``msgpack.packb``
and reads the reference's manifests. For the reduced vlm's training
state ``{"params", "opt", "health"}`` (f32; bridged weights, random
moments), a reference checkpoint loads into the port leaf by leaf, and
the port's save gives the reference's ``manifest.msgpack`` and ``.npy``
bytes, which the reference's ``load(d, like)`` restores. bf16 shards
are ``np.save``'s bytes of ``ml_dtypes`` arrays both ways. The
reference's own checkpoint tests (error messages, checksums, frozen
shards hardlinked forward) run against the port."""
import io
import os

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

import jax

from repro.checkpoint import checkpoint as jckpt
from repro.models import mllm as jmllm
from repro.optim import optimizer as jopt
from repro_torch import bridge
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import CheckpointError, Stacked
from repro_torch.models import mllm as tmllm
from repro_torch.resilience import corrupt_shard

META = {"seed": 0, "mllm": "vlm", "plan": "{" + "p" * 70000 + "}",
        "mode": "replay", "step": 2, "cursor": 2, "clip_scale": 0.5,
        "crc": 2 ** 31 + 12345, "neg": -70000, "none": None, "on": True,
        "off": False, "shape": [3, 0, 2 ** 40], "nested": {"a": [1.5, -2]}}


@pytest.fixture(scope="module")
def state():
    """The reduced vlm's state as the reference keeps it (numpy leaves)
    and as the port keeps it (bridged), the moments drawn from a seed."""
    jm = jmllm.build_paper_mllm("vlm", reduced=True)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jo = jax.tree.map(np.asarray, jopt.init(jopt.AdamWConfig(), jp,
                                            jm.frozen_mask(jp)))
    rng = np.random.default_rng(3)
    for kind in ("m", "v"):
        jo[kind] = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32)
            if x.size else x, jo[kind])
    jo["step"] = np.asarray(7, np.int32)
    jh = {"ema": np.asarray(6.25, np.float32),
          "var": np.asarray(0.125, np.float32),
          "count": np.asarray(3, np.int32)}
    tm = tmllm.build_paper_mllm("vlm", reduced=True)
    tp = bridge.mllm_from_jax_params(jp, tm, device="cpu")
    to = bridge.opt_state_from_jax(jo, tp)
    th = {"ema": np.float32(6.25), "var": np.float32(0.125),
          "count": np.int32(3)}
    return {"jax": {"params": jp, "opt": jo, "health": jh},
            "torch": (tp, to, th), "mllm": tm}


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def _np(t):
    t = t.detach()
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# The manifest's MessagePack subset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("obj", [
    META, {"step": 0, "entries": [], "meta": {}}, 2 ** 64 - 1, -2 ** 63,
    [-33, -32, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32],
    ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536, "é✓"],
    [list(range(15)), list(range(16)), list(range(70000))],
    {str(i): float(i) / 3 for i in range(20)}, [None, True, False, -0.0,
                                               float("inf")]],
    ids=["manifest-meta", "empty", "uint64", "int64", "ints", "strs",
         "arrays", "map16", "singletons"])
def test_msgpack_is_byte_equal(obj):
    blob = msgpack.packb(obj)
    assert _msgpack.packb(obj) == blob
    assert _msgpack.unpackb(blob) == msgpack.unpackb(blob)


def test_msgpack_refuses_what_a_manifest_never_holds():
    with pytest.raises(TypeError):
        _msgpack.packb({"a": np.float32(1.0)})
    blob = _msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="incomplete"):
        _msgpack.unpackb(blob[:-1])
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(blob + b"\x00")


# ---------------------------------------------------------------------------
# The bridge's way back
# ---------------------------------------------------------------------------

def _equal_trees(got, want):
    flat_g, flat_w = (ckpt.paths_and_leaves(t) for t in (got, want))
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, b) in zip(flat_g, flat_w):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("kind", ["qwen3-1.7b", "vlm"])
def test_bridge_way_back_is_the_exact_inverse(kind, state):
    """to_jax_params / mllm_to_jax_params undo from_jax_params /
    mllm_from_jax_params leaf for leaf (the layer axis stacked again),
    and opt_state_to_jax undoes opt_state_from_jax."""
    if kind == "vlm":
        want, tp = state["jax"]["params"], state["torch"][0]
        got = bridge.mllm_to_jax_params(tp, state["mllm"])
        _equal_trees(bridge.opt_state_to_jax(state["torch"][1], tp),
                     state["jax"]["opt"])
    else:
        from repro.configs.base import get_config as jget
        from repro.models import api as japi
        from repro_torch.configs.base import get_config
        cfg = get_config(kind, reduced=True)
        want = jax.tree.map(np.asarray, japi.init(
            jax.random.PRNGKey(1), jget(kind, reduced=True)))
        got = bridge.to_jax_params(
            bridge.from_jax_params(want, cfg, device="cpu"), cfg)
    _equal_trees(got, want)


# ---------------------------------------------------------------------------
# Both packages, one layout
# ---------------------------------------------------------------------------

def test_reference_checkpoint_loads_into_the_port(state, tmp_path):
    d = str(tmp_path / "ref")
    jckpt.save(d, state["jax"], step=9, meta=META)
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        blob = f.read()
    assert _msgpack.unpackb(blob) == msgpack.unpackb(blob)
    # a restore target from another seed with zero moments, filled in
    # place from the reference's files
    tm = state["mllm"]
    tp = tm.init(device="cpu", generator=torch.Generator().manual_seed(5))
    to = bridge.opt_state_from_jax(jax.tree.map(
        np.zeros_like, state["jax"]["opt"]), tp)
    tree, step = ckpt.load(d, bridge.state_tree(tp, to, {
        "ema": 0.0, "var": 0.0, "count": 0}))
    assert step == 9 and int(tree["opt"]["step"]) == 7
    assert float(tree["health"]["ema"]) == 6.25
    assert int(tree["health"]["count"]) == 3
    want = bridge.mllm_to_jax_params(tp, tm)
    for (p1, a), (p2, b) in zip(ckpt.paths_and_leaves(want),
                                ckpt.paths_and_leaves(
                                    state["jax"]["params"])):
        assert p1 == p2
        np.testing.assert_array_equal(a, b, err_msg=p1)
    got_opt = bridge.opt_state_to_jax(to, tp)
    for kind in ("m", "v"):
        for (p1, a), (p2, b) in zip(
                ckpt.paths_and_leaves(got_opt[kind]),
                ckpt.paths_and_leaves(state["jax"]["opt"][kind])):
            assert p1 == p2
            np.testing.assert_array_equal(a, b, err_msg=f"{kind}/{p1}")
    assert all(p.requires_grad == (not tm.frozen_mask(tp)[n])
               for n, p in tp.named_parameters())


def test_port_checkpoint_is_the_references_byte_for_byte(state, tmp_path):
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(ref, state["jax"], step=9, meta=META)
    man = ckpt.save(port, bridge.state_tree(*state["torch"]), step=9,
                    meta=META)
    want, got = _files(ref), _files(port)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert man == jckpt.read_manifest(ref)
    # the reference restores the port's checkpoint
    tree, step = jckpt.load(port, like=state["jax"])
    assert step == 9
    for (p1, a), (p2, b) in zip(ckpt.paths_and_leaves(tree),
                                ckpt.paths_and_leaves(state["jax"])):
        assert p1 == p2
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=p1)


def test_bf16_shards_are_ml_dtypes_bytes(tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3, 5, generator=g).bfloat16()
    layers = [torch.randn(2, 4, generator=g).bfloat16() for _ in range(3)]
    d = str(tmp_path / "port")
    man = ckpt.save(d, {"w": w, "layers": {"a": Stacked(layers)}})
    assert [e["dtype"] for e in man["entries"]] == ["bfloat16", "bfloat16"]
    for e, t in zip(man["entries"], [torch.stack(layers), w]):
        buf = io.BytesIO()
        np.save(buf, _np(t).view(ml_dtypes.bfloat16))
        assert open(os.path.join(d, e["file"]), "rb").read() == \
            buf.getvalue(), e["path"]
    # the reference reads them as raw 2-byte values: the same bits
    arrays, _ = jckpt.load(d)
    assert arrays["w"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(arrays["w"].view(np.uint16), _np(w))
    # and the port reads a reference-written bf16 shard back exactly
    ref = str(tmp_path / "ref")
    jckpt.save(ref, {"w": _np(w).view(ml_dtypes.bfloat16)}, step=1)
    got, step = ckpt.load(ref)
    assert step == 1 and torch.equal(got["w"], w)
    into = torch.zeros(3, 5, dtype=torch.bfloat16)
    ckpt.load(ref, {"w": into})
    assert torch.equal(into, w)


# ---------------------------------------------------------------------------
# The reference's own checkpoint tests, against the port
# ---------------------------------------------------------------------------

def test_load_errors_name_offending_path_and_shape(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, {"w": np.zeros((4, 2), np.float32)}, step=1)
    with pytest.raises(CheckpointError) as e:
        ckpt.load(d, like={"w": torch.zeros(5, 2)})
    assert "'w'" in str(e.value) and "(4, 2)" in str(e.value) \
        and "(5, 2)" in str(e.value)
    with pytest.raises(CheckpointError) as e:
        ckpt.load(d, like={"w": torch.zeros(4, 2), "b": torch.zeros(2)})
    assert "'b'" in str(e.value) and "missing" in str(e.value)
    os.remove(os.path.join(d, "arr_0.npy"))
    with pytest.raises(CheckpointError, match="'arr_0.npy'.*is missing"):
        ckpt.load(d)


def test_manifest_missing_and_truncated_errors(tmp_path):
    with pytest.raises(CheckpointError, match="manifest.msgpack is "
                                              "missing"):
        ckpt.load(str(tmp_path / "nope"))
    d = str(tmp_path / "ck")
    ckpt.save(d, {"w": np.zeros(3, np.float32)}, step=1)
    mpath = os.path.join(d, "manifest.msgpack")
    with open(mpath, "rb") as f:
        blob = f.read()
    with open(mpath, "wb") as f:
        f.write(blob[:len(blob) // 2])          # torn write
    with pytest.raises(CheckpointError, match="corrupt or truncated"):
        ckpt.load(d)


def test_corrupted_or_truncated_shard_is_detected(tmp_path):
    """Bit rot in a shard fails the load with the shard named, before
    anything is written into the restore target."""
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(12, dtype=torch.float32),
            "b": torch.ones(3)}
    ckpt.save(d, tree, step=5)
    corrupt_shard(d, 1)                          # 'w' (paths sort b, w)
    like = {"w": torch.zeros(12), "b": torch.zeros(3)}
    with pytest.raises(CheckpointError) as e:
        ckpt.load(d, like=like)
    assert "crc32" in str(e.value) and "arr_1.npy" in str(e.value)
    assert not like["b"].any()                   # nothing was written
    # verify=False is the explicit escape hatch (e.g. forensics)
    _, step = ckpt.load(d, like=like, verify=False)
    assert step == 5 and torch.equal(like["b"], tree["b"])
    with open(os.path.join(d, "arr_0.npy"), "r+b") as f:
        f.truncate(os.path.getsize(os.path.join(d, "arr_0.npy")) - 4)
    with pytest.raises(CheckpointError, match="arr_0.npy.*unreadable"):
        ckpt.load(d, verify=False)


def test_frozen_shards_are_reused_and_hardlinked(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    tree = {"enc": {"w": torch.ones(4)}, "proj": torch.zeros(2)}
    man1 = ckpt.save(d1, tree, step=1)
    tree["proj"] += 1
    man2 = ckpt.save(d2, tree, step=2, frozen_paths={"enc"},
                     prev_manifest=man1, prev_dir=d1)
    assert man2["entries"][0] == man1["entries"][0]
    assert os.stat(os.path.join(d2, "arr_0.npy")).st_nlink == 2
    got, _ = ckpt.load(d2)
    assert torch.equal(got["proj"], tree["proj"])
    # the reference reads the reused shard too
    arrays, step = jckpt.load(d2)
    assert step == 2 and np.array_equal(arrays["enc/w"], np.ones(4))


def test_a_leaf_held_nowhere_is_refused(tmp_path):
    with pytest.raises(CheckpointError, match="no rank holds"):
        ckpt.save(str(tmp_path / "ck"),
                  {"w": torch.zeros(3, device="meta")})
