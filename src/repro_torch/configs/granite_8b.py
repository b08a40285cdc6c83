"""Granite-8B code — llama-arch dense decoder [arXiv:2405.04324]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=49_152,
    source="arXiv:2405.04324 (Granite Code)",
)
