"""Qwen2.5-14B [hf:Qwen/Qwen2.5-14B; family per Qwen/Qwen2.5-0.5B card]
— dense, GQA(kv=8), QKV bias."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense", num_layers=48, d_model=5120,
        num_heads=40, num_kv_heads=8, d_ff=13824, vocab_size=152064,
        head_dim=128, rope_theta=1e6, qkv_bias=True,
        source="hf:Qwen/Qwen2.5-0.5B",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="qwen2.5-14b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        dtype="float32", remat=False, seq_shard_activations=False,
        loss_chunk=0,
    )


register("qwen2.5-14b", full, reduced)
