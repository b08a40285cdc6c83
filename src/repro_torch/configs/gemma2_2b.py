"""Gemma-2 2B — local+global alternating attention, logit softcap [arXiv:2408.00118]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    d_ff=9216, vocab_size=256_000, head_dim=256,
    attention_pattern="local_global", window_size=4096,
    logit_softcap=30.0, attn_softcap=50.0, scale_embed=True,
    source="arXiv:2408.00118 (Gemma 2)",
)
