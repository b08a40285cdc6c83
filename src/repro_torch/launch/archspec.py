"""Per-architecture deployment decisions (counterpart of
``repro/launch/archspec.py``): the placement and client count each
architecture runs at on the production mesh, its algorithm and
microbatching, and which input shapes apply to it.

* placement / client count — the reference's memory napkin math per pod;
* algorithm — fedbioacc everywhere it fits; llama3-405b runs fedbio
  (Algorithm 1: one body-sized persistent tensor per client instead of two);
* microbatching — bounds activation memory of the remat'd loss;
* shape applicability — decode shapes skip the encoder-only architecture;
  long_500k only for sub-quadratic families (ssm / hybrid / gemma2's
  sliding-window layers).

The tables are the reference's, so a dry run of the port sizes the same
deployments the reference lowers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.config import INPUT_SHAPES, MeshConfig, ModelConfig


@dataclass(frozen=True)
class DeploySpec:
    placement: str            # client_sharded | client_replicated |
                              # client_pure | dp_within_client
    num_clients: int          # single-pod client count (doubles on multi-pod
                              # for client_sharded)
    algorithm: str            # fedbio | fedbioacc
    n_micro_train: int        # microbatches per client in train_4k
    serve_fsdp: bool          # shard serve-params over "data" too
    fuse_oracles: bool = False  # one shared linearization for the oracles


_SPECS = {
    "llama3-405b": DeploySpec("client_replicated", 2, "fedbio", 16, True),
    "internvl2-76b": DeploySpec("client_replicated", 2, "fedbioacc", 16, True),
}
_DEFAULT = DeploySpec("client_sharded", 16, "fedbioacc", 4, False)

# the optimized deployments: fused oracles everywhere; client_pure for the
# sub-2B archs (256 clients consume the whole mesh, no tensor-parallel
# activation all-reduces); gemma2-2b data-parallel within each client
_OPTIMIZED = {
    "llama3-405b": DeploySpec("client_replicated", 2, "fedbio", 8, True, True),
    "internvl2-76b": DeploySpec("client_replicated", 2, "fedbioacc", 8, True,
                                True),
    "mamba2-130m": DeploySpec("client_pure", 256, "fedbioacc", 1, False, True),
    "granite-moe-1b-a400m": DeploySpec("client_pure", 256, "fedbioacc", 1,
                                       False, True),
    "gemma2-2b": DeploySpec("dp_within_client", 16, "fedbioacc", 4, False,
                            True),
}
_OPT_DEFAULT = DeploySpec("client_sharded", 16, "fedbioacc", 4, False, True)

# long_500k is run only for sub-quadratic attention
_LONG_OK = {"mamba2-130m", "recurrentgemma-9b", "gemma2-2b"}


def deploy_spec(arch: str, optimized: bool = False) -> DeploySpec:
    if optimized:
        return _OPTIMIZED.get(arch, _OPT_DEFAULT)
    return _SPECS.get(arch, _DEFAULT)


def num_clients(arch: str, mesh: MeshConfig, optimized: bool = False) -> int:
    spec = deploy_spec(arch, optimized)
    if spec.placement == "client_pure" and mesh.multi_pod:
        # the global batch (256) cannot feed 512 pure clients: multi-pod
        # keeps the single-pod client count, replicated over the pod axis
        return spec.num_clients
    if spec.placement == "client_sharded" and mesh.multi_pod:
        return spec.num_clients * 2      # client axis spans ("pod", "data")
    return spec.num_clients


def shape_applicable(arch: str, cfg: ModelConfig, shape_name: str
                     ) -> Tuple[bool, Optional[str]]:
    """(runs?, skip_reason)."""
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "decode":
        if cfg.family == "audio":
            return False, "encoder-only architecture has no decode step"
        if shape_name == "long_500k" and arch not in _LONG_OK:
            return False, ("pure full-attention architecture; long_500k "
                           "requires sub-quadratic attention")
    return True, None


def all_combos():
    """The 10 × 4 grid of (arch, shape, runs?, skip_reason)."""
    from repro_torch.configs import ARCHS
    out = []
    for arch, cfg in ARCHS.items():
        for shape_name in INPUT_SHAPES:
            ok, reason = shape_applicable(arch, cfg, shape_name)
            out.append((arch, shape_name, ok, reason))
    return out
