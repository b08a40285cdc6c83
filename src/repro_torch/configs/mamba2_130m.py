"""Mamba-2 130M — SSD state-space duality, attention-free [arXiv:2405.21060]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_heads=24, ssm_head_dim=64, ssm_chunk=256, conv_width=4,
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
)
