"""HuBERT X-Large — encoder-only audio transformer [arXiv:2106.07447].

The conv/mel front end is a stub, as in the reference: the model takes
precomputed 512-dim frame embeddings, which a learned projection maps into
the model width.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, causal=False, frontend_dim=512,
    source="arXiv:2106.07447 (HuBERT)",
)
