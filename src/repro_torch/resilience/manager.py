"""Atomic, resumable, retained checkpoints (the counterpart of
``repro.resilience.manager``) over ``repro_torch.checkpoint``.

Layout under one root::

    <root>/step_00000010/     — one complete checkpoint per step
        manifest.msgpack      — shards + crc32s + bundled meta (data
                                cursor, RNG seed, plan JSON, ...)
        arr_*.npy
    <root>/LATEST             — name of the newest complete checkpoint
    <root>/.tmp-step_*        — in-flight saves (never readable)

Crash-safety is rename-based: a save writes every shard and the
manifest into a ``.tmp-`` dir, then ``os.replace``s it to its final
name and rewrites ``LATEST`` through its own temp file. A process
killed at ANY point leaves either the previous checkpoint set intact
(tmp dir is garbage, collected on the next manager construction) or
the new one fully visible — never a half-written dir that ``load``
could mistake for a checkpoint. ``latest()`` trusts ``LATEST`` but
falls back to scanning step dirs (a crash can land between the two
renames), so recovery never depends on the pointer file.

Retention keeps the newest ``keep`` checkpoints. Frozen-module shards
are hardlinked forward from the previous step's dir (``skip_frozen``
via ``checkpoint.save``'s ``prev_dir``), which makes retention safe by
construction: deleting an old dir drops a link, not the bytes.

With ``group`` (a ``torch.distributed`` group whose ranks share the
root; every rank makes the same calls), one checkpoint is written by
all ranks together (``checkpoint.save(group=)``): rank 0 collects
garbage, prepares the temp dir, writes the manifest and does the
renames, and barriers keep the ranks in step. ``restore`` is local:
each rank reads only the leaves its restore target holds. A root
shared by ranks on several hosts must be a shared filesystem.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _step_name(step: int) -> str:
    if step < 0:
        raise ValueError(f"checkpoint step must be >= 0, got {step}")
    return f"step_{step:08d}"


class CheckpointManager:
    """Owns one checkpoint root: atomic saves, ``latest()`` discovery,
    retention, and frozen-shard reuse across steps."""

    def __init__(self, root: str, *, keep: int = 3,
                 frozen_paths: Optional[set] = None, group=None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.root = root
        self.keep = keep
        self.frozen_paths = frozen_paths
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        os.makedirs(root, exist_ok=True)
        if self.rank == 0:
            # collect garbage from saves a previous process died inside of
            for name in os.listdir(root):
                if name.startswith(".tmp-"):
                    shutil.rmtree(os.path.join(root, name),
                                  ignore_errors=True)
        self._barrier()
        self._prev: Optional[Tuple[str, dict]] = None
        last = self.latest()
        if last is not None:
            self._prev = (last, ckpt.read_manifest(last))

    def _barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    # -- discovery ---------------------------------------------------------

    def steps(self) -> List[int]:
        """Steps of every complete checkpoint under the root, sorted."""
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name,
                                                 "manifest.msgpack")):
                out.append(int(m.group(1)))
        return sorted(out)

    def dir_for(self, step: int) -> str:
        return os.path.join(self.root, _step_name(step))

    def latest(self) -> Optional[str]:
        """Dir of the newest complete checkpoint (None if there is
        none). Reads ``LATEST`` first; falls back to a scan when the
        pointer is missing or stale (crash between the two renames)."""
        marker = os.path.join(self.root, "LATEST")
        if os.path.exists(marker):
            with open(marker, encoding="utf-8") as f:
                name = f.read().strip()
            d = os.path.join(self.root, name)
            if os.path.exists(os.path.join(d, "manifest.msgpack")):
                return d
        steps = self.steps()
        return self.dir_for(steps[-1]) if steps else None

    # -- save / restore ----------------------------------------------------

    def save(self, step: int, tree, *, meta: Optional[Dict[str, Any]]
             = None, on_entry=None) -> str:
        """Atomically persist ``tree`` (+ ``meta``) as the step's
        checkpoint; returns the final dir. ``on_entry`` forwards to
        ``checkpoint.save`` (the kill-mid-save fault hook)."""
        name = _step_name(step)
        tmp = os.path.join(self.root, f".tmp-{name}")
        if self.rank == 0 and os.path.exists(tmp):
            shutil.rmtree(tmp)
        self._barrier()
        prev_dir, prev_man = self._prev if self._prev else (None, None)
        manifest = ckpt.save(tmp, tree, step=step, meta=meta,
                             frozen_paths=self.frozen_paths,
                             prev_manifest=prev_man, prev_dir=prev_dir,
                             on_entry=on_entry, group=self.group)
        final = os.path.join(self.root, name)
        if self.rank == 0:
            if os.path.exists(final):   # re-save of the same step
                shutil.rmtree(final)
            os.replace(tmp, final)
            lat_tmp = os.path.join(self.root, ".LATEST.tmp")
            with open(lat_tmp, "w", encoding="utf-8") as f:
                f.write(name + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(lat_tmp, os.path.join(self.root, "LATEST"))
            self._retain()
        self._barrier()
        self._prev = (final, manifest)
        return final

    def restore(self, like=None, *, step: Optional[int] = None,
                verify: bool = True):
        """Load the newest (or a specific step's) checkpoint into
        ``like`` (in place, see ``checkpoint.load``). Returns ``(tree,
        step, meta)``; raises ``CheckpointError`` when there is nothing
        to restore or the data fails validation."""
        d = self.dir_for(step) if step is not None else self.latest()
        if d is None:
            raise ckpt.CheckpointError(
                f"no checkpoint to restore under {self.root!r}")
        tree, got_step = ckpt.load(d, like, verify=verify)
        meta = ckpt.read_manifest(d).get("meta", {})
        return tree, got_step, meta

    def peek_meta(self) -> Dict[str, Any]:
        """Meta of the newest checkpoint WITHOUT loading any arrays
        (empty dict when there is no checkpoint). Lets a launcher
        inspect e.g. ``meta["mode"]`` / ``meta["spmd_layout"]`` before
        deciding what shape of state tree to restore into."""
        d = self.latest()
        if d is None:
            return {}
        return dict(ckpt.read_manifest(d).get("meta", {}))

    # -- retention ---------------------------------------------------------

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir_for(s), ignore_errors=True)
