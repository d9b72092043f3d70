"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
from repro_torch.configs.base import ModelConfig, register, MLSTM, SLSTM

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                      # xLSTM blocks carry their own up/down projections
    vocab_size=50304,
    block_pattern=(MLSTM, MLSTM, MLSTM, SLSTM),
    xlstm_proj_factor=2.0,
    source="arXiv:2405.04517; unverified",
))
