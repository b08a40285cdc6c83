"""InternVL2-76B — VLM: LM decoder backbone + ViT stub front end
[arXiv:2404.16821].

The InternViT tower and its projector are a stub, as in the reference: the
model takes 3200-dim patch embeddings (256 patches an image), which a
learned projection maps into the LM's embedding space, placed before the
tokens.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128_256, head_dim=128,
    num_patches=256, frontend_dim=3200, rope_theta=500_000.0,
    source="arXiv:2404.16821 (InternVL2)",
)
