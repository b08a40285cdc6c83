"""RecurrentGemma-9B — RG-LRU + local attention hybrid [arXiv:2402.19427]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256_000, head_dim=256,
    lru_width=4096, attention_pattern="rg", window_size=2048,
    conv_width=4, scale_embed=True,
    source="arXiv:2402.19427 (Griffin/RecurrentGemma)",
)
