"""Synthetic data pipeline (the counterpart of ``repro.data.synthetic``).
The paper trains on synthetic multimodal batches: ~1k text tokens plus
one 1280x720 image and one 30 s audio clip per sample, the modality
tokens placed mid-text.

- ``TextLMDataset``: seeded random-token LM batches.
- ``MultimodalDataset``: text plus stubbed frame/patch embeddings, and
  the merged sequence's BAM bits in the paper's three mask modes
  (Fig. 11): EP (encoder outputs prepended), EE (embedded mid-text), MP
  (several documents packed per row).

Arrays are drawn on the host with numpy in the JAX package's order, so
the same seed gives equal arrays; each batch is then moved to
``device`` as torch tensors (int32 tokens, f32 embeddings).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bam
from repro_torch.device import resolve_device


def _to(arr: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).astype(dtype)).to(
        device)


@dataclasses.dataclass
class TextLMDataset:
    """Seeded synthetic LM stream. ``noise = 1.0`` gives i.i.d. uniform
    tokens; ``noise < 1`` draws from a fixed first-order Markov chain
    (next = perm[cur] w.p. 1-noise), a learnable distribution."""
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    noise: float = 0.1
    device: str = "cuda"

    def __iter__(self) -> Iterator[dict]:
        dev = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        perm = np.random.default_rng(1234).permutation(self.vocab_size)
        while True:
            if self.noise >= 1.0:
                tok = rng.integers(0, self.vocab_size,
                                   (self.batch_size, self.seq_len + 1),
                                   dtype=np.int64)
            else:
                tok = np.empty((self.batch_size, self.seq_len + 1),
                               np.int64)
                tok[:, 0] = rng.integers(0, self.vocab_size,
                                         self.batch_size)
                for t in range(1, self.seq_len + 1):
                    nxt = perm[tok[:, t - 1]]
                    rand = rng.integers(0, self.vocab_size,
                                        self.batch_size)
                    flip = rng.random(self.batch_size) < self.noise
                    tok[:, t] = np.where(flip, rand, nxt)
            pos = np.broadcast_to(np.arange(self.seq_len, dtype=np.int32),
                                  (self.batch_size, self.seq_len))
            yield {"tokens": _to(tok[:, :-1], np.int32, dev),
                   "labels": _to(tok[:, 1:], np.int32, dev),
                   "positions": _to(pos, np.int32, dev)}


def sample_segments(mode: str, text_len: int, mod_tokens: Dict[int, int],
                    rng: np.random.Generator,
                    docs: int = 1) -> List[Tuple]:
    """A segment list for ``bam.build_sample_bits``. mode: "ep"
    (modality prepended), "ee" (embedded mid-text), "mp" (several packed
    documents, each ee-style)."""
    segs: List[Tuple] = []
    for d in range(docs):
        if d > 0:
            segs.append(("newdoc", 0, 0))
        if mode == "ep":
            for m, n in mod_tokens.items():
                segs.append(("mod", m, n))
            segs.append(("text", 0, text_len))
        else:  # ee (and each packed doc in mp)
            cuts = sorted(rng.integers(1, max(text_len - 1, 2),
                                       len(mod_tokens)))
            prev = 0
            for (m, n), c in zip(mod_tokens.items(), cuts):
                segs.append(("text", 0, int(c - prev)))
                segs.append(("mod", m, n))
                prev = c
            segs.append(("text", 0, int(text_len - prev)))
    return segs


@dataclasses.dataclass
class MultimodalDataset:
    """Yields Cornstarch MLLM batches: text tokens, labels and one
    stub embedding stream per encoder (``<name>_embeds``)."""
    vocab_size: int
    text_len: int
    batch_size: int
    encoder_dims: Dict[str, int]          # name -> d_model
    encoder_tokens: Dict[str, int]        # name -> emitted tokens
    modality_ids: Dict[str, int]          # name -> BAM bit
    mask_mode: str = "ee"                 # ep | ee | mp
    docs_per_row: int = 1                 # >1 only for mp
    seed: int = 0
    device: str = "cuda"

    def __iter__(self) -> Iterator[dict]:
        dev = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        shape = (self.batch_size, self.text_len)
        while True:
            out = {"text_tokens": _to(rng.integers(0, self.vocab_size, shape),
                                      np.int32, dev),
                   "labels": _to(rng.integers(0, self.vocab_size, shape),
                                 np.int32, dev)}
            for name, d in self.encoder_dims.items():
                n = self.encoder_tokens[name]
                out[f"{name}_embeds"] = _to(
                    rng.normal(0, 1, (self.batch_size, n, d)), np.float32,
                    dev)
            yield out

    def merged_bits(self, rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """One row's merged-sequence BAM bits and positions (numpy)."""
        rng = rng or np.random.default_rng(self.seed)
        mt = {self.modality_ids[n]: self.encoder_tokens[n]
              for n in self.encoder_dims}
        per_doc_text = self.text_len // self.docs_per_row
        segs = sample_segments(self.mask_mode, per_doc_text, mt, rng,
                               docs=self.docs_per_row)
        total = self.text_len + self.docs_per_row * sum(mt.values())
        return bam.build_sample_bits(segs, total)


def random_multimodal_bits(seq_len: int, mode: str, G_hint: int = 8,
                           seed: int = 0, n_modalities: int = 2
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Random mask instances: a seq_len sequence with randomly sized
    modality streams (EP/EE) or randomly packed documents (MP)."""
    rng = np.random.default_rng(seed)
    if mode == "mp":
        docs = int(rng.integers(3, 9))
        text = int(seq_len * 0.6)
        mod_total = seq_len - text
        per_doc_mod = {m + 1: max(mod_total // docs // n_modalities, 1)
                       for m in range(n_modalities)}
        segs = sample_segments("mp", text // docs, per_doc_mod, rng,
                               docs=docs)
    else:
        frac = rng.uniform(0.2, 0.5)
        mod_total = int(seq_len * frac)
        mt = {m + 1: mod_total // n_modalities for m in range(n_modalities)}
        text = seq_len - sum(mt.values())
        segs = sample_segments(mode, text, mt, rng)
    return bam.build_sample_bits(segs, seq_len)
