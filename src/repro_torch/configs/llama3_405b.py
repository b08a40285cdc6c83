"""Llama-3 405B — GQA dense decoder, 128k vocab [arXiv:2407.21783]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128_256, head_dim=128,
    rope_theta=500_000.0,
    source="arXiv:2407.21783 (Llama 3)",
)
