"""Qwen3-1.7B [hf:Qwen/Qwen3-1.7B, family per Qwen/Qwen3-8B card] —
dense, GQA(kv=8), qk_norm, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense", num_layers=28, d_model=2048,
        num_heads=16, num_kv_heads=8, d_ff=6144, vocab_size=151936,
        head_dim=128, rope_theta=1e6, use_qk_norm=True, tie_embeddings=True,
        decode_kv_replicate=16,
        source="hf:Qwen/Qwen3-8B",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="qwen3-1.7b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        dtype="float32", remat=False, seq_shard_activations=False,
        loss_chunk=0,
        decode_kv_replicate=4,   # valid for the 4-head reduced variant
    )


register("qwen3-1.7b", full, reduced)
