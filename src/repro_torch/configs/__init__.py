"""The architecture catalog: ``get_config(arch)`` resolves here (the
reference's ten)."""
from repro_torch.configs import (gemma2_2b, granite_3_8b, granite_8b,
                                 granite_moe_1b_a400m, hubert_xlarge,
                                 internvl2_76b, llama3_405b, mamba2_130m,
                                 olmoe_1b_7b, recurrentgemma_9b)

ARCHS = {
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "gemma2-2b": gemma2_2b.CONFIG,
    "mamba2-130m": mamba2_130m.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "granite-3-8b": granite_3_8b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b_a400m.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
    "granite-8b": granite_8b.CONFIG,
}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]
