"""Ported architectures: ``get_config(arch)`` resolves here.  Only the
architectures whose model family the port runs are listed; the two whose
front end is not ported keep their family in ``UNPORTED``."""
from repro_torch.configs import (gemma2_2b, granite_3_8b, granite_8b,
                                 granite_moe_1b_a400m, llama3_405b,
                                 mamba2_130m, olmoe_1b_7b, recurrentgemma_9b)

ARCHS = {
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "gemma2-2b": gemma2_2b.CONFIG,
    "mamba2-130m": mamba2_130m.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "granite-3-8b": granite_3_8b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b_a400m.CONFIG,
    "granite-8b": granite_8b.CONFIG,
}

# the reference's other architectures, by family
UNPORTED = {"hubert-xlarge": "audio", "internvl2-76b": "vlm"}

FAMILIES_ITEM = "ROADMAP queue 1, item 'Other model families and serving'"


def get_config(name: str):
    if name not in ARCHS:
        family = UNPORTED.get(name)
        what = f"the {family} front end" if family else "it"
        raise NotImplementedError(
            f"arch {name!r} is not ported yet ({what}; ported: "
            f"{sorted(ARCHS)}); see {FAMILIES_ITEM}")
    return ARCHS[name]
