"""Granite-3.0 8B base — GQA dense decoder [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12800, vocab_size=49_155,
    source="hf:ibm-granite/granite-3.0-2b-base (Granite 3.0)",
)
