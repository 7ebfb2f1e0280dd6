"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + shared attention
block applied every 6 layers (parameter sharing)."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
        num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
        head_dim=80, attn_layer_period=6, shared_attn=True,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      chunk=128),
        source="arXiv:2411.15242",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="zamba2-2.7b-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        attn_layer_period=2,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=8),
        dtype="float32", remat=False, seq_shard_activations=False,
        loss_chunk=0,
    )


register("zamba2-2.7b", full, reduced)
