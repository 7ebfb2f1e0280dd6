"""xLSTM-125M [arXiv:2405.04517] — mLSTM + sLSTM mix (sLSTM at blocks
3 and 9, xLSTM[.. :1] style); blocks carry their own projections
(d_ff = 0 in the assigned spec)."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm", num_layers=12, d_model=768,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
        head_dim=192, tie_embeddings=True,
        xlstm=XLSTMConfig(slstm_at=(3, 9), proj_factor_m=2.0,
                          conv_kernel=4, chunk=64),
        source="arXiv:2405.04517",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="xlstm-125m-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, vocab_size=512,
        xlstm=XLSTMConfig(slstm_at=(1,), proj_factor_m=2.0, conv_kernel=4,
                          chunk=8),
        dtype="float32", remat=False, seq_shard_activations=False,
        loss_chunk=0,
    )


register("xlstm-125m", full, reduced)
