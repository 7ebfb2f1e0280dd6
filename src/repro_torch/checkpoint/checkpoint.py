"""Sharded checkpointing (the counterpart of ``repro.checkpoint``): a
tree -> manifest.msgpack + one ``.npy`` shard per leaf, in the same
layout, so that either package loads what the other wrote.

Layout:
    <dir>/manifest.msgpack   — ``{"step", "entries", "meta"}``; each entry
                               is ``{"path", "file", "shape", "dtype",
                               "crc32"}`` in that key order
    <dir>/arr_<i>.npy        — one file per leaf, ``i`` in flatten order

A tree is nested dicts (keys sorted at every level, as JAX flattens
them) and lists; its ``/``-joined key paths name the leaves. A leaf is
a ``torch.Tensor`` on any device, a :class:`Stacked` list of tensors
(one per layer, written as the array that stacks them on a new leading
axis, which is how the JAX package keeps a layer stack), or anything
``np.asarray`` takes. ``bridge.state_tree`` gives the port's training
state in the reference's layout.

Shards stream: each tensor (each layer of a :class:`Stacked` leaf) is
copied to the host, checksummed and written on its own, so the host
holds one layer's bytes at a time. The bytes are ``np.save``'s: the same
header and the raw C-order data. numpy has no bfloat16, so a bf16 tensor
is written through an int16 view under the header descr ``'<V2'``,
which is what ``np.save`` writes for an ``ml_dtypes.bfloat16`` array;
its manifest dtype is ``"bfloat16"``.

Frozen modules are saved once: when ``frozen_paths`` and
``prev_manifest`` are given, a frozen leaf's shard is reused from this
dir or hardlinked (copied as a fallback) from ``prev_dir``. Every shard
carries a crc32 over its data bytes; ``load`` checks them all before it
writes anything and raises :class:`CheckpointError` naming the shard.

``load(d, like)`` restores in place: each tensor of ``like`` (each layer
of a :class:`Stacked` leaf) gets the shard's values copied into it, on
its own device, with its own dtype and ``requires_grad``; other leaves
come back as numpy arrays of the like leaf's dtype.

With ``group`` (a ``torch.distributed`` group; every rank calls
``save``), the ranks write one checkpoint between them: a rank writes
the tensors it holds (not on the meta device) and rank 0 the host
leaves, each shard under its global flatten index; rank 0 gathers the
entries and writes the manifest, which is the one a single process
saving the whole tree writes. The ranks must share ``ckpt_dir``.
"""
from __future__ import annotations

import os
import shutil
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

#: bytes read at a time when checksumming a shard
_CHUNK = 64 << 20

_TORCH_DTYPES = {torch.float32: "float32", torch.float64: "float64",
                 torch.float16: "float16", torch.bfloat16: "bfloat16",
                 torch.int64: "int64", torch.int32: "int32",
                 torch.int16: "int16", torch.int8: "int8",
                 torch.uint8: "uint8", torch.bool: "bool"}


class CheckpointError(ValueError):
    """A checkpoint failed validation: missing/truncated manifest,
    missing shard, shape mismatch, or checksum failure. The message
    always names the checkpoint dir and the offending path/file."""


class Stacked:
    """One leaf held as per-layer tensors: the array of shape
    ``[len(parts), *parts[0].shape]`` that stacking them gives. Parts on
    the meta device belong to another rank."""

    def __init__(self, parts):
        self.parts = list(parts)
        if not self.parts:
            raise ValueError("a Stacked leaf needs at least one part")
        p0 = self.parts[0]
        for p in self.parts[1:]:
            if p.shape != p0.shape or p.dtype != p0.dtype:
                raise ValueError(f"Stacked parts differ: {tuple(p.shape)} "
                                 f"{p.dtype} vs {tuple(p0.shape)} {p0.dtype}")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.parts),) + tuple(self.parts[0].shape)

    @property
    def dtype(self):
        return self.parts[0].dtype


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def paths_and_leaves(tree) -> List[Tuple[str, Any]]:
    """[(``/``-joined path, leaf)] in JAX's flatten order: dict keys
    sorted, lists by index; ``None`` is an empty subtree."""
    out: List[Tuple[str, Any]] = []

    def walk(node, parts):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], parts + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, parts + [str(i)])
        elif node is not None:
            out.append(("/".join(parts), node))

    walk(tree, [])
    return out


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves taken from ``leaves`` in
    flatten order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    if tree is None:
        return None
    return next(leaves)


def _parts(leaf) -> Optional[List[torch.Tensor]]:
    """The tensors a leaf is written from (None for a host leaf)."""
    if isinstance(leaf, Stacked):
        return leaf.parts
    if isinstance(leaf, torch.Tensor):
        return [leaf]
    return None


def _dtype_name(leaf) -> str:
    if isinstance(leaf, (Stacked, torch.Tensor)):
        if leaf.dtype not in _TORCH_DTYPES:
            raise TypeError(f"no checkpoint dtype for {leaf.dtype}")
        return _TORCH_DTYPES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def _descr(name: str) -> str:
    return "<V2" if name == "bfloat16" else \
        np.lib.format.dtype_to_descr(np.dtype(name))


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's C-order bytes on the host (bf16 through int16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().cpu().numpy().reshape(-1).view(np.uint8)


def _write(fpath: str, leaf) -> Tuple[List[int], str, int]:
    """Write one leaf as ``np.save`` would; (shape, dtype name, crc32)."""
    parts = _parts(leaf)
    name = _dtype_name(leaf)
    if parts is None:
        arr = np.asarray(leaf)
        shape, chunks = arr.shape, [np.ascontiguousarray(arr)]
    else:
        shape, chunks = leaf.shape, (_host_bytes(p) for p in parts)
    crc = 0
    with open(fpath, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _descr(name), "fortran_order": False,
            "shape": tuple(int(s) for s in shape)})
        for chunk in chunks:
            data = chunk.reshape(-1).view(np.uint8)
            crc = zlib.crc32(data, crc)
            f.write(data)
    return [int(s) for s in shape], name, crc & 0xFFFFFFFF


def _owned(leaf, rank: int) -> bool:
    """Whether this rank writes ``leaf``: tensors where they are held
    (all parts off the meta device), host leaves on rank 0."""
    parts = _parts(leaf)
    if parts is None:
        return rank == 0
    meta = [p.is_meta for p in parts]
    if any(meta) and not all(meta):
        raise CheckpointError("a Stacked leaf is held only in part here; "
                              "a save needs each leaf whole on one rank")
    return not meta[0]


def _rank_world(group) -> Tuple[int, int]:
    if group is None:
        return 0, 1
    import torch.distributed as dist
    return dist.get_rank(group), dist.get_world_size(group)


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def _save_share(ckpt_dir, flat, rank, frozen_paths, prev_manifest,
                prev_dir, on_entry) -> List[Tuple[int, dict]]:
    prev = {e["path"]: e for e in prev_manifest["entries"]} \
        if prev_manifest else {}
    mine = []
    for i, (path, leaf) in enumerate(flat):
        if not _owned(leaf, rank):
            continue
        if frozen_paths and prev_manifest and path in prev and \
                any(path.startswith(fp) for fp in frozen_paths):
            old = prev[path]
            if os.path.exists(os.path.join(ckpt_dir, old["file"])):
                mine.append((i, old))
                continue
            if prev_dir is not None:
                src = os.path.join(prev_dir, old["file"])
                if os.path.exists(src):
                    dst = os.path.join(ckpt_dir, old["file"])
                    try:
                        os.link(src, dst)
                    except OSError:
                        shutil.copyfile(src, dst)
                    mine.append((i, old))
                    continue
        fname = f"arr_{i}.npy"
        shape, dtype, crc = _write(os.path.join(ckpt_dir, fname), leaf)
        mine.append((i, {"path": path, "file": fname, "shape": shape,
                         "dtype": dtype, "crc32": crc}))
        if on_entry is not None:
            on_entry(i, path)
    return mine


def save(ckpt_dir: str, tree, *, step: int = 0,
         frozen_paths: Optional[set] = None,
         prev_manifest: Optional[dict] = None,
         prev_dir: Optional[str] = None,
         meta: Optional[dict] = None,
         on_entry: Optional[Callable[[int, str], None]] = None,
         group=None) -> dict:
    """Write ``tree`` under ``ckpt_dir``; returns the manifest.

    ``on_entry(i, path)`` fires after shard ``i`` hits disk (the
    kill-mid-save fault hook). With ``group``, every rank of it calls
    this with the same tree structure; see the module docstring. A rank
    that fails makes every rank raise, after the others have finished
    their shares."""
    rank, world = _rank_world(group)
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = paths_and_leaves(tree)
    if group is None:
        mine = _save_share(ckpt_dir, flat, rank, frozen_paths,
                           prev_manifest, prev_dir, on_entry)
        shares = [(mine, None)]
    else:
        import torch.distributed as dist
        failure = None
        try:
            mine = _save_share(ckpt_dir, flat, rank, frozen_paths,
                               prev_manifest, prev_dir, on_entry)
        except Exception as e:          # reported to every rank below
            mine, failure = [], e
        shares = [None] * world
        dist.all_gather_object(
            shares, (mine, None if failure is None
                     else f"{type(failure).__name__}: {failure}"),
            group=group)
        if failure is not None:
            raise failure
        bad = [(r, err) for r, (_, err) in enumerate(shares) if err]
        if bad:
            raise CheckpointError(
                f"checkpoint {ckpt_dir!r}: rank(s) failed their share of the "
                f"save: " + "; ".join(f"rank {r}: {err}" for r, err in bad))
    by_index: Dict[int, dict] = {}
    for share, _ in shares:
        for i, entry in share:
            if i in by_index:
                raise CheckpointError(
                    f"checkpoint {ckpt_dir!r}: leaf {entry['path']!r} was "
                    f"written by two ranks")
            by_index[i] = entry
    missing = [flat[i][0] for i in range(len(flat)) if i not in by_index]
    if missing:
        raise CheckpointError(
            f"checkpoint {ckpt_dir!r}: no rank holds {missing[:4]} "
            f"({len(missing)} leaves)")
    manifest = {"step": step,
                "entries": [by_index[i] for i in range(len(flat))],
                "meta": meta or {}}
    if rank == 0:
        tmp = os.path.join(ckpt_dir, "manifest.msgpack.tmp")
        with open(tmp, "wb") as f:
            f.write(_msgpack.packb(manifest))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(ckpt_dir, "manifest.msgpack"))
    if group is not None:
        import torch.distributed as dist
        dist.barrier(group=group)
    return manifest


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

def read_manifest(ckpt_dir: str) -> dict:
    """Parse ``<dir>/manifest.msgpack`` or raise :class:`CheckpointError`
    (missing file, truncated/garbled msgpack) with a clear message."""
    mpath = os.path.join(ckpt_dir, "manifest.msgpack")
    if not os.path.exists(mpath):
        raise CheckpointError(
            f"no checkpoint at {ckpt_dir!r}: manifest.msgpack is missing")
    try:
        with open(mpath, "rb") as f:
            manifest = _msgpack.unpackb(f.read())
    except Exception as e:  # truncated write, garbage bytes, ...
        raise CheckpointError(
            f"checkpoint manifest at {mpath!r} is corrupt or truncated: "
            f"{type(e).__name__}: {e}") from None
    if not isinstance(manifest, dict) or "entries" not in manifest:
        raise CheckpointError(
            f"checkpoint manifest at {mpath!r} has no 'entries' record "
            f"(got {type(manifest).__name__})")
    return manifest


class _Shard:
    """One shard's header, read and checked against its manifest entry:
    ``shape``, ``dtype`` (a manifest dtype name), the data ``offset`` and
    size."""

    def __init__(self, ckpt_dir: str, e: dict):
        self.path = os.path.join(ckpt_dir, e["file"])
        where = f"checkpoint {ckpt_dir!r}: shard {e['file']!r} for path " \
                f"{e['path']!r}"
        if not os.path.exists(self.path):
            raise CheckpointError(f"{where} is missing")
        try:
            with open(self.path, "rb") as f:
                version = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if version ==
                        (1, 0) else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read(f)
                self.offset = f.tell()
            if fortran:
                raise ValueError("Fortran-order shards are not written here")
            if dtype == np.dtype("V2"):
                if e.get("dtype") != "bfloat16":
                    raise ValueError(f"raw 2-byte data but the manifest "
                                     f"dtype is {e.get('dtype')!r}")
                self.dtype, self.itemsize = "bfloat16", 2
            else:
                self.dtype, self.itemsize = str(dtype), dtype.itemsize
            self.nbytes = int(np.prod(shape, dtype=np.int64)) * self.itemsize
            size = os.path.getsize(self.path) - self.offset
            if size < self.nbytes:
                raise ValueError(f"{size} data bytes, {self.nbytes} needed")
        except Exception as err:
            raise CheckpointError(f"{where} is unreadable: "
                                  f"{type(err).__name__}: {err}") from None
        self.shape = tuple(shape)
        if list(shape) != list(e["shape"]):
            raise CheckpointError(
                f"checkpoint {ckpt_dir!r}: path {e['path']!r} has shape "
                f"{list(shape)} on disk but the manifest says "
                f"{list(e['shape'])}")
        self.where = where

    def crc(self) -> int:
        crc, left = 0, self.nbytes
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            while left:
                data = f.read(min(_CHUNK, left))
                crc = zlib.crc32(data, crc)
                left -= len(data)
        return crc & 0xFFFFFFFF

    def read(self, start: int = 0, count: Optional[int] = None
             ) -> torch.Tensor:
        """Elements [start, start + count) as a flat CPU tensor."""
        n = self.nbytes // self.itemsize if count is None else count
        data = bytearray(n * self.itemsize)
        with open(self.path, "rb") as f:
            f.seek(self.offset + start * self.itemsize)
            f.readinto(data)
        if self.dtype == "bfloat16":
            return torch.frombuffer(data, dtype=torch.int16).view(
                torch.bfloat16) if n else torch.empty(0, dtype=torch.bfloat16)
        if not n:
            return torch.from_numpy(np.empty(0, np.dtype(self.dtype)))
        return torch.from_numpy(np.frombuffer(data, np.dtype(self.dtype)))

    def array(self) -> np.ndarray:
        """The whole shard as a numpy array (not for bfloat16)."""
        return self.read().numpy().reshape(self.shape)


def _needed(leaf) -> bool:
    """Whether ``leaf`` of a restore target is loaded here: host leaves
    always, tensors held here (any part off the meta device)."""
    parts = _parts(leaf)
    return parts is None or any(not p.is_meta for p in parts)


@torch.no_grad()
def load(ckpt_dir: str, like=None, *, verify: bool = True):
    """Returns (tree, step). If ``like`` is given, restores into that
    structure (validating paths and shapes, then copying in place; see
    the module docstring); otherwise returns {path: CPU tensor}.
    ``verify=True`` (default) checks the crc32 of every shard it reads
    before anything is written, and raises :class:`CheckpointError`
    naming the shard on mismatch (entries without a ``crc32`` skip the
    check)."""
    manifest = read_manifest(ckpt_dir)
    entries = {e["path"]: e for e in manifest["entries"]}

    def checked(e) -> _Shard:
        shard = _Shard(ckpt_dir, e)
        if verify and e.get("crc32") is not None and \
                shard.crc() != e["crc32"]:
            raise CheckpointError(
                f"checkpoint {ckpt_dir!r}: shard {e['file']!r} for path "
                f"{e['path']!r} failed its crc32 checksum — the file is "
                f"corrupt; restore from an older checkpoint")
        return shard

    if like is None:
        shards = {p: checked(e) for p, e in entries.items()}
        return ({p: s.read().reshape(s.shape) for p, s in shards.items()},
                manifest["step"])
    flat = paths_and_leaves(like)
    shards: Dict[str, _Shard] = {}
    for path, leaf in flat:
        if path not in entries:
            raise CheckpointError(
                f"checkpoint {ckpt_dir!r} is missing path {path!r} "
                f"required by the restore target structure")
        want = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else np.shape(leaf)
        if tuple(entries[path]["shape"]) != tuple(want):
            raise CheckpointError(
                f"checkpoint {ckpt_dir!r}: path {path!r} has shape "
                f"{tuple(entries[path]['shape'])} but the restore target "
                f"expects {tuple(want)}")
        if _needed(leaf):
            shards[path] = checked(entries[path])
    out = []
    for path, leaf in flat:
        shard = shards.get(path)
        parts = _parts(leaf)
        if shard is None:
            out.append(leaf)
        elif parts is None:
            dtype = leaf.dtype if hasattr(leaf, "dtype") \
                else np.asarray(leaf).dtype
            out.append(shard.array().astype(dtype))
        else:
            per = int(np.prod(parts[0].shape, dtype=np.int64))
            for k, p in enumerate(parts):
                if not p.is_meta:
                    src = shard.read(k * per, per).reshape(p.shape)
                    p.copy_(src)
            out.append(leaf)
    return _rebuild(like, iter(out)), manifest["step"]
