"""Bitfield Attention Mask (BAM) — Cornstarch §4.3.1, the port's copy of
``repro.core.bam``.

Bit layout of one token's bitfield:

    [15:0]   attends-set  A_i : bit m set => token i may attend modality m
    [22:16]  own modality m_i : 0 = text, 1..15 = encoder streams
    [30:23]  instance id  d_i : packed-document id
    value 0                  : padding token (never attends / attended)

The port carries bitfields as **int32**: the top field ends at bit 30, so
every legal value is below 2^31, and PyTorch on the CPU has no right
shift for uint32. The CUDA kernels read the same int32 words and
reinterpret them as unsigned.

Mask semantics (mirrored by the kernels):

    allowed(i, j) =
        bits_q[i] != 0 and bits_k[j] != 0
        and d_i == d_j
        and (A_i >> m_j) & 1
        and ( m_i == 0  ->  pos_j <= pos_i   (and pos_i - pos_j < window)
              m_i != 0  ->  m_j == m_i )

``allowed_mask`` works on torch tensors; ``allowed_mask_np`` is the
numpy twin for host-side planning (``build_block_map``), so the host
never calls torch for it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

TEXT = 0
ATTEND_BITS = 16
MOD_SHIFT = 16
MOD_BITS = 7
INST_SHIFT = 23
INST_BITS = 8

_ATTEND_MASK = (1 << ATTEND_BITS) - 1
_MOD_MASK = (1 << MOD_BITS) - 1
_INST_MASK = (1 << INST_BITS) - 1


def encode(attends: int, modality: int, instance: int = 0) -> int:
    if not (0 <= attends <= _ATTEND_MASK and 0 <= modality <= _MOD_MASK
            and 0 <= instance <= _INST_MASK):
        raise ValueError(
            f"bitfield out of range: attends={attends} modality={modality} "
            f"instance={instance}")
    return attends | (modality << MOD_SHIFT) | (instance << INST_SHIFT)


def text_token(attend_modalities: Sequence[int] = (), instance: int = 0) -> int:
    """A text token attends text + the given encoder modality streams."""
    a = 1 << TEXT
    for m in attend_modalities:
        a |= 1 << m
    return encode(a, TEXT, instance)


def modality_token(modality: int, instance: int = 0) -> int:
    """Encoder-output tokens attend (bidirectionally) their own stream."""
    if modality == TEXT:
        raise ValueError("modality_token needs an encoder modality (>= 1)")
    return encode(1 << modality, modality, instance)


# -- field extraction (torch tensors or numpy arrays of int32/int64) --------

def attends_set(bits):
    return bits & _ATTEND_MASK


def own_modality(bits):
    return (bits >> MOD_SHIFT) & _MOD_MASK


def instance_id(bits):
    return (bits >> INST_SHIFT) & _INST_MASK


def _allowed(qb, kb, qp, kp, window: int):
    """The mask rule on broadcast operands; written with operators only,
    so the same code runs on torch tensors and numpy arrays."""
    nonpad = (qb != 0) & (kb != 0)
    same_doc = instance_id(qb) == instance_id(kb)
    km = own_modality(kb)
    in_set = km < ATTEND_BITS
    # an attends-set has 16 bits: a key modality >= 16 is never in it
    bit_ok = in_set & (((attends_set(qb) >> (km * in_set)) & 1) != 0)
    q_text = own_modality(qb) == TEXT
    causal = kp <= qp
    if window:
        causal = causal & ((qp - kp) < window)
    within = km == own_modality(qb)
    rule = (q_text & causal) | (~q_text & within)
    return nonpad & same_doc & bit_ok & rule


def allowed_mask(q_bits, kv_bits, q_pos, kv_pos, window: int = 0):
    """Expand BAM to a boolean mask. q_bits: [..., Tq] int32; kv_bits:
    [..., Tk]; q_pos/kv_pos: int32 explicit positions. Returns bool
    [..., Tq, Tk] (torch)."""
    qb = q_bits[..., :, None].to(torch.int32)
    kb = kv_bits[..., None, :].to(torch.int32)
    return _allowed(qb, kb, q_pos[..., :, None], kv_pos[..., None, :], window)


def allowed_mask_np(q_bits, kv_bits, q_pos, kv_pos, window: int = 0):
    """Numpy twin of ``allowed_mask`` for host-side planning."""
    qb = np.asarray(q_bits).astype(np.int64)[..., :, None]
    kb = np.asarray(kv_bits).astype(np.int64)[..., None, :]
    qp = np.asarray(q_pos).astype(np.int64)[..., :, None]
    kp = np.asarray(kv_pos).astype(np.int64)[..., None, :]
    return _allowed(qb, kb, qp, kp, window)


def causal_bits(batch: int, seq: int, device="cuda"):
    """Degenerate BAM for a pure-text causal LM."""
    return torch.full((batch, seq), text_token(), dtype=torch.int32,
                      device=resolve_device(device))


def repeat_kv(k, n_rep: int):
    """GQA head expansion [B, T, Hkv, hd] -> [B, T, Hkv*n_rep, hd]."""
    if n_rep == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(
        b, t, h * n_rep, d)


# ---------------------------------------------------------------------------
# Per-token workload (row-sums of the mask), numpy, for the token
# distribution planners (core.distribution): O(T * M) from per-modality
# cumulative counts, never the [T, T] mask
# ---------------------------------------------------------------------------

def token_workload(bits: np.ndarray, pos: np.ndarray,
                   window: int = 0) -> np.ndarray:
    """bits/pos: [T]. Returns float64 [T]: W_i = the number of keys
    token i attends, the row-sum of ``allowed_mask``."""
    bits = np.asarray(bits).astype(np.int64)
    pos = np.asarray(pos, np.int64)
    T = bits.shape[0]
    mod = own_modality(bits)
    inst = instance_id(bits)
    att = attends_set(bits)
    nonpad = bits != 0

    W = np.zeros(T, np.float64)
    for d in np.unique(inst[nonpad]):
        idx = np.where(nonpad & (inst == d))[0]
        idx = idx[np.argsort(pos[idx], kind="stable")]
        m, a, p = mod[idx], att[idx], pos[idx]
        mods_here = np.unique(m)
        w = np.zeros(idx.shape[0], np.float64)
        text_rows = m == TEXT
        for mm in mods_here:
            bit_ok = ((a >> int(mm)) & 1) != 0
            # text queries: modality-mm keys with pos_i - window < pos_j
            # <= pos_i, counted per modality
            pos_mm = p[m == mm]                  # ascending (p is sorted)
            hi = np.searchsorted(pos_mm, p, side="right")
            lo = np.searchsorted(pos_mm, p - window, side="right") \
                if window else 0
            w += np.where(text_rows & bit_ok, hi - lo, 0.0)
            # modality queries: their whole own stream (the window
            # constrains text queries only, as in allowed_mask)
            if mm != TEXT:
                w += np.where((m == mm) & bit_ok, float((m == mm).sum()),
                              0.0)
        W[idx] = w
    return W


def block_workload(bits: np.ndarray, pos: np.ndarray, block: int,
                   window: int = 0) -> np.ndarray:
    """Token workloads summed over contiguous blocks of ``block`` tokens
    (the planners assign whole blocks); the last block is zero-padded."""
    W = token_workload(bits, pos, window)
    T = W.shape[0]
    nb = (T + block - 1) // block
    padded = np.zeros(nb * block, np.float64)
    padded[:T] = W
    return padded.reshape(nb, block).sum(axis=1)


# ---------------------------------------------------------------------------
# Host-side grid compaction (numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockMask:
    """Active (q-block, k-block) tiles of one mask instance, q-major and
    k-major, each step (i_major, i_minor, first, last, active)."""
    block_q: int
    block_k: int
    nq: int
    nk: int
    window: int
    q_steps: Tuple[Tuple[int, int, int, int, int], ...]
    k_steps: Tuple[Tuple[int, int, int, int, int], ...]

    @property
    def n_steps(self) -> int:
        return len(self.q_steps)

    @property
    def n_dense_steps(self) -> int:
        return self.nq * self.nk

    @property
    def skip_fraction(self) -> float:
        active = sum(s[4] for s in self.q_steps)
        return 1.0 - active / max(self.n_dense_steps, 1)

    def arrays(self, major: str = "q"):
        steps = self.q_steps if major == "q" else self.k_steps
        cols = np.asarray(steps, np.int32).reshape(len(steps), 5)
        return tuple(np.ascontiguousarray(cols[:, j]) for j in range(5))

    def active_tiles(self, major: str = "q") -> np.ndarray:
        """[nq, nk] bool: the tiles that one step list (q-major for the
        forward and dQ, k-major for dK/dV) marks active."""
        steps = self.q_steps if major == "q" else self.k_steps
        active = np.zeros((self.nq, self.nk), bool)
        for iq, ik, _, _, on in steps:
            if not (0 <= iq < self.nq and 0 <= ik < self.nk):
                raise ValueError(f"block map step ({iq}, {ik}) lies outside "
                                 f"its {self.nq} x {self.nk} grid")
            active[iq, ik] |= bool(on)
        return active


def _flatten_active(active: np.ndarray) -> Tuple[Tuple[int, ...], ...]:
    steps = []
    for i in range(active.shape[0]):
        js = np.flatnonzero(active[i])
        if js.size == 0:
            steps.append((i, 0, 1, 1, 0))
            continue
        for t, j in enumerate(js):
            steps.append((i, int(j), int(t == 0), int(t == js.size - 1), 1))
    return tuple(steps)


def build_block_map(q_bits, kv_bits, q_pos, kv_pos, block_q: int,
                    block_k: int, window: int = 0) -> BlockMask:
    """Block-level reduction of the bitfield mask. Accepts [T] or [B, T]
    arrays; a tile is active if any batch row has an allowed pair in it.
    Sequences are padded to block multiples with bits=0, pos=-1."""
    q_bits = np.atleast_2d(np.asarray(q_bits).astype(np.int64))
    kv_bits = np.atleast_2d(np.asarray(kv_bits).astype(np.int64))
    q_pos = np.atleast_2d(np.asarray(q_pos, np.int64))
    kv_pos = np.atleast_2d(np.asarray(kv_pos, np.int64))
    Tq, Tk = q_bits.shape[1], kv_bits.shape[1]
    nq = -(-Tq // block_q)
    nk = -(-Tk // block_k)

    def _pad(x, to, value=0):
        pad = to - x.shape[1]
        if pad:
            x = np.pad(x, ((0, 0), (0, pad)), constant_values=value)
        return x

    qb = _pad(q_bits, nq * block_q)
    kb = _pad(kv_bits, nk * block_k)
    qp = _pad(q_pos, nq * block_q, -1)
    kp = _pad(kv_pos, nk * block_k, -1)
    # strip by strip: host memory O(B·block_q·Tk), never the full mask
    active = np.zeros((nq, nk), bool)
    for iq in range(nq):
        s = slice(iq * block_q, (iq + 1) * block_q)
        strip = allowed_mask_np(qb[:, s], kb, qp[:, s], kp, window)
        active[iq] = strip.reshape(-1, block_q, nk, block_k).any(
            axis=(0, 1, 3))
    return block_map_from_tiles(active, block_q, block_k, window)


def block_map_from_tiles(active: np.ndarray, block_q: int, block_k: int,
                         window: int = 0) -> BlockMask:
    """The BlockMask whose q-major and k-major step lists hold exactly the
    tiles of ``active`` [nq, nk] bool (what ``build_block_map`` derives
    from a mask; a pruned copy of ``BlockMask.active_tiles()`` makes a
    map that leaves tiles out)."""
    active = np.asarray(active, bool)
    nq, nk = active.shape
    return BlockMask(block_q=block_q, block_k=block_k, nq=nq, nk=nk,
                     window=window,
                     q_steps=_flatten_active(active),
                     k_steps=tuple((i, j, f, l, a) for (j, i, f, l, a)
                                   in _flatten_active(active.T)))


class BlockCSR(NamedTuple):
    """A block map's active tiles as int32 CSR on one device: row iq of
    ``q_ptr``/``q_cols`` lists q-block iq's active k-blocks, row ik of
    ``k_ptr``/``k_rows`` k-block ik's active q-blocks, both ascending.
    Row j of ``k64_ptr``/``k64_rows`` lists the q-blocks active in
    k-block 2j or 2j + 1 (the k-major rows' ascending union), each as 4 *
    q-block + a flag per k-block (1: 2j active, 2: 2j + 1 active), for a
    kernel whose block owns two k-blocks (the bf16 K3). The compacted
    kernels walk these rows (the Pallas kernels' first / last / active
    flags become the row bounds)."""
    q_ptr: torch.Tensor     # [nq + 1]
    q_cols: torch.Tensor    # [active tiles of the q-major list]
    k_ptr: torch.Tensor     # [nk + 1]
    k_rows: torch.Tensor    # [active tiles of the k-major list]
    k64_ptr: torch.Tensor   # [ceil(nk / 2) + 1]
    k64_rows: torch.Tensor  # [entries of the k-block pairs' union]


def _csr(active: np.ndarray, device):
    ptr = np.zeros(active.shape[0] + 1, np.int32)
    np.cumsum(active.sum(axis=1), out=ptr[1:])
    idx = np.nonzero(active)[1].astype(np.int32)    # row-major: ascending
    return (torch.from_numpy(ptr).to(device),
            torch.from_numpy(np.ascontiguousarray(idx)).to(device))


def _pair_csr(active_k: np.ndarray, device):
    """CSR of k-block pairs from the k-major activity [nk, nq]: per pair
    row, the q-blocks active in either, as 4 * q-block + half flags."""
    nk, nq = active_k.shape
    halves = np.zeros(((nk + 1) // 2, 2, nq), np.int32)
    halves.reshape(-1, nq)[:nk] = active_k
    flags = halves[:, 0] | (halves[:, 1] << 1)      # [pairs, nq]
    rows, cols = np.nonzero(flags)                  # row-major: ascending
    ptr = np.zeros(flags.shape[0] + 1, np.int32)
    np.cumsum((flags != 0).sum(axis=1), out=ptr[1:])
    idx = (4 * cols + flags[rows, cols]).astype(np.int32)
    return (torch.from_numpy(ptr).to(device),
            torch.from_numpy(np.ascontiguousarray(idx)).to(device))


@functools.lru_cache(maxsize=64)
def _block_csr(block_map: BlockMask, device: torch.device) -> BlockCSR:
    q_ptr, q_cols = _csr(block_map.active_tiles("q"), device)
    active_k = block_map.active_tiles("k").T
    k_ptr, k_rows = _csr(active_k, device)
    return BlockCSR(q_ptr, q_cols, k_ptr, k_rows,
                    *_pair_csr(active_k, device))


def block_csr(block_map: BlockMask, device) -> BlockCSR:
    """``block_map``'s CSR arrays on ``device``, uploaded once per (map,
    device): a BlockMask is frozen and hashable."""
    return _block_csr(block_map, torch.device(device))


def tile_mask(block_map: BlockMask, Tq: int, Tk: int, device,
              major: str = "q"):
    """[Tq, Tk] bool: True on the pairs inside the active tiles of one
    step list, cropped to the unpadded lengths. The plain versions of the
    compacted kernels AND it with the BAM mask."""
    active = torch.from_numpy(block_map.active_tiles(major))
    return (active.repeat_interleave(block_map.block_q, 0)
            .repeat_interleave(block_map.block_k, 1)[:Tq, :Tk]
            .to(resolve_device(device)))


def build_sample_bits(segments: Sequence[Tuple[str, int, int]],
                      seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """segments: (kind, modality_id, length) with kind in {"text", "mod",
    "newdoc"}; "newdoc" starts a new instance and restarts positions.
    Returns (bits [T] int32, pos [T] int32), zero-padded to seq_len."""
    bits, pos = [], []
    inst = 0
    p = 0
    seen_mods: set[int] = set()
    for kind, m, n in segments:
        if kind == "newdoc":
            inst += 1
            p = 0
            seen_mods = set()
            continue
        if kind == "mod":
            seen_mods.add(m)
            tok = modality_token(m, inst)
        else:
            tok = text_token(sorted(seen_mods), inst)
        bits.extend([tok] * n)
        pos.extend(range(p, p + n))
        p += n
    if len(bits) > seq_len:
        raise ValueError(f"segments hold {len(bits)} tokens > {seq_len}")
    out_b = np.zeros(seq_len, np.int32)
    out_p = np.zeros(seq_len, np.int32)
    out_b[: len(bits)] = bits
    out_p[: len(pos)] = pos
    return out_b, out_p
