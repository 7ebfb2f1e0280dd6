"""Qwen2-VL language backbone (arXiv:2409.12191) — M-RoPE + merged
vision tokens (the counterpart of ``repro.models.vlm``).

The ViT/patch-merger frontend is stubbed: the caller provides
precomputed patch embeddings ``[B, n_patches, d_model]`` plus an image
grid (t, h, w). This module builds the merged multimodal batch (BAM
bitfields: vision tokens bidirectional within the image stream, text
causal, the paper's "encoder outputs embedded" mask; and the 3-D M-RoPE
position ids), then delegates to the dense transformer. Like the
reference, it has no ``hidden``: ``training.steps.make_prefill`` takes
the full forward for it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bam
from repro_torch.models import transformer as T

VISION = 1  # modality bit for the vision stream

init = T.init
init_cache = T.init_cache


def mrope_positions(seq_len: int, img_start: int, grid: tuple[int, int, int]):
    """[3, T] int32 (temporal, h, w) position ids for one sample with one
    image of ``grid`` = (t, h, w) patches starting at ``img_start``.
    Text positions: all three streams equal (plain RoPE). Vision
    positions: the temporal/h/w index within the grid, offset by the
    text position where the image sits; trailing text continues after
    the largest position the image used."""
    gt, gh, gw = grid
    n_img = gt * gh * gw
    pos = np.zeros((3, seq_len), np.int32)
    pos[:, :img_start] = np.arange(img_start)
    pos[0, img_start:img_start + n_img] = img_start + np.repeat(
        np.arange(gt), gh * gw)
    pos[1, img_start:img_start + n_img] = img_start + np.tile(
        np.repeat(np.arange(gh), gw), gt)
    pos[2, img_start:img_start + n_img] = img_start + np.tile(
        np.arange(gw), gt * gh)
    nxt = img_start + max(gt, gh, gw)
    tail = seq_len - (img_start + n_img)
    pos[:, img_start + n_img:] = nxt + np.arange(tail)
    return pos


def make_vlm_batch(tokens, patch_embeds, img_start: int,
                   grid: tuple[int, int, int], d_model: int):
    """tokens: [B,T] (image positions hold a placeholder id);
    patch_embeds: [B, n_img, d]. Returns a transformer batch on tokens'
    device with merged embeddings, BAM bits (int32), sequential
    positions, embed_mask and M-RoPE pos3 [3,B,T]."""
    B, T_ = tokens.shape
    n_img = int(np.prod(grid))
    if patch_embeds.shape[1] != n_img:
        raise ValueError(f"patch_embeds hold {patch_embeds.shape[1]} "
                         f"patches; grid {tuple(grid)} has {n_img}")
    dev = tokens.device
    seg = [("text", 0, img_start), ("mod", VISION, n_img),
           ("text", 0, T_ - img_start - n_img)]
    bits_np, pos_np = bam.build_sample_bits(seg, T_)
    embed_mask_np = np.zeros((T_,), bool)
    embed_mask_np[img_start:img_start + n_img] = True
    inputs_embeds = torch.zeros((B, T_, d_model), dtype=patch_embeds.dtype,
                                device=dev)
    inputs_embeds[:, img_start:img_start + n_img] = patch_embeds
    pos3 = torch.from_numpy(mrope_positions(T_, img_start, grid)).to(dev)
    return {
        "tokens": tokens,
        "positions": torch.from_numpy(pos_np).to(dev)[None].expand(B, T_),
        "bits": torch.from_numpy(bits_np).to(dev)[None].expand(B, T_),
        "inputs_embeds": inputs_embeds,
        "embed_mask": torch.from_numpy(embed_mask_np).to(dev)[None].expand(
            B, T_),
        "pos3": pos3[:, None].expand(3, B, T_),
    }


def forward(model, cfg: ModelConfig, batch):
    return T.forward(model, cfg, batch)


def decode_step(model, cfg: ModelConfig, cache, batch):
    return T.decode_step(model, cfg, cache, batch)
