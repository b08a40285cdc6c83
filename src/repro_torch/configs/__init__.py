"""Ported architectures: ``get_config(arch)`` resolves here.  Only the
architectures whose model family the port runs are listed."""
from repro_torch.configs import mamba2_130m, recurrentgemma_9b

ARCHS = {
    "mamba2-130m": mamba2_130m.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
}


def get_config(name: str):
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {sorted(ARCHS)}); "
            f"see ROADMAP queue 1, item 'Other model families and serving'")
    return ARCHS[name]
