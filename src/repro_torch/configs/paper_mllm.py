"""The paper's own evaluation LLMs (Table 1), Llama-3.1-style in S/M/L;
``llm_config("M")`` has Llama-3.1-8B widths. (The JAX package's
vision and audio encoder configs come with the training slice.)"""
from repro_torch.configs.base import ModelConfig

# Table 1: (layers, hidden) per size
_LLM = {"S": (16, 2048), "M": (32, 4096), "L": (64, 5120)}


def llm_config(size: str = "M", reduced: bool = False) -> ModelConfig:
    L, d = _LLM[size]
    cfg = ModelConfig(
        name=f"paper-llama-{size}", family="dense", num_layers=L, d_model=d,
        num_heads=max(d // 128, 1), num_kv_heads=max(d // 512, 1),
        d_ff=int(3.5 * d), vocab_size=128256, head_dim=128,
        rope_theta=5e5, source="arXiv:2407.21783 (Llama 3.1 herd)",
    )
    if reduced:
        cfg = cfg.replace(num_layers=2, d_model=256, num_heads=4,
                          num_kv_heads=2, head_dim=64, d_ff=512,
                          vocab_size=512, dtype="float32", remat=False,
                          seq_shard_activations=False, loss_chunk=0)
    return cfg

