"""Configuration dataclasses of the PyTorch port (counterpart of
``repro/config.py``).

* :class:`ModelConfig`     — architecture hyper-parameters.
* :class:`FederatedConfig` — the paper's algorithm knobs (M clients, I local
  steps, learning rates, STORM constants, Neumann terms) and the clients'
  placement on the mesh.
* :class:`InputShape` / :data:`INPUT_SHAPES` — the four assigned input
  shapes the dry run sizes every architecture at.
* :class:`MeshConfig` — the production mesh (``[16, 16]``, or ``[2, 16,
  16]`` across two pods) the placement rules divide the leaves over.

Field names, defaults and :meth:`ModelConfig.reduced` are the JAX package's,
so that one experiment spec means the same model and the same schedule in
both; ``FederatedConfig`` carries the fields an experiment sets and those
the problem-level algorithms of ``repro_torch.core`` read.  The
TPU roofline constants of the JAX package are not carried over: the port's
device numbers come from runs on the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense, moe, ssm, hybrid, audio, vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    num_experts: int = 0
    experts_per_token: int = 0
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    lru_width: int = 0
    attention_pattern: str = "global"
    window_size: int = 0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    causal: bool = True
    num_patches: int = 0
    frontend_dim: int = 0
    scale_embed: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind, length == num_layers."""
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.family == "hybrid":
            # recurrentgemma: repeating (recurrent, recurrent, local attention)
            pat = ("rec", "rec", "local")
            return tuple(pat[i % 3] for i in range(self.num_layers))
        if self.attention_pattern == "local_global":
            return tuple("local" if i % 2 == 0 else "attn"
                         for i in range(self.num_layers))
        return ("attn",) * self.num_layers

    def reduced(self, num_layers: int = 2, d_model: int = 256, d_ff: int = 512,
                vocab_size: int = 512, num_experts: int = 4) -> "ModelConfig":
        """A tiny same-family variant for CPU tests (same rules as the JAX
        package's ``ModelConfig.reduced``)."""
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = min(self.num_kv_heads, max(1, heads // 2)) if self.num_kv_heads else 0
        changes = dict(
            num_layers=num_layers,
            d_model=d_model,
            d_ff=d_ff if self.d_ff else 0,
            vocab_size=vocab_size,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=(d_model // heads if heads else self.ssm_head_dim),
        )
        if self.num_experts:
            changes["num_experts"] = num_experts
            changes["experts_per_token"] = min(self.experts_per_token, 2)
        if self.family == "ssm":
            changes["ssm_state"] = 16
            changes["ssm_heads"] = 4
            changes["ssm_head_dim"] = 32
            changes["ssm_chunk"] = 32
            changes["num_heads"] = 0
            changes["num_kv_heads"] = 0
            changes["head_dim"] = 0
        if self.family == "hybrid":
            changes["lru_width"] = d_model
            changes["num_layers"] = 3
        if self.window_size:
            changes["window_size"] = 64
        if self.num_patches:
            changes["num_patches"] = 8
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class FederatedConfig:
    algorithm: str = "fedbioacc"
    num_clients: int = 16
    local_steps: int = 4             # I in the paper
    lr_x: float = 0.05
    lr_y: float = 0.1
    lr_u: float = 0.1
    # STORM constants: c_nu, c_omega, c_u and alpha_t = delta/(u0+t)^{1/3}
    c_nu: float = 1.0
    c_omega: float = 1.0
    c_u: float = 1.0
    alpha_delta: float = 1.0
    alpha_u0: float = 8.0
    neumann_q: int = 8
    neumann_tau: float = 0.5
    lower_l2: float = 1e-2
    # client placement on the mesh (launch/archspec.py, sharding/rules.py)
    placement: str = "client_sharded"   # or "client_replicated"
    # CommFedBiO's top-k ratio
    compress_ratio: float = 0.1
    hierarchy_period: int = 0
    hierarchy_groups: int = 2
    # the problem-level algorithms' switches (the model-scale trainers take
    # them as keyword arguments): one shared minibatch and linearization
    # for the oracle directions; the flat substrate with its fused kernel
    # launch per local step, over tiles of fuse_storm_block elements
    fuse_oracles: bool = False
    fuse_storm: bool = False
    fuse_storm_block: int = 1024
    seed: int = 0


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


# ---------------------------------------------------------------------------
# Mesh configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n
