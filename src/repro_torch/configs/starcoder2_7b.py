"""StarCoder2-7B [arXiv:2402.19173] — dense, GQA(kv=4), RoPE, layernorm,
gelu MLP, learned biases on QKV."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense", num_layers=32, d_model=4608,
        num_heads=36, num_kv_heads=4, d_ff=18432, vocab_size=49152,
        head_dim=128, rope_theta=1e5, qkv_bias=True, act="gelu",
        norm="layernorm", source="arXiv:2402.19173",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="starcoder2-7b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        dtype="float32", remat=False, seq_shard_activations=False,
        loss_chunk=0,
    )


register("starcoder2-7b", full, reduced)
