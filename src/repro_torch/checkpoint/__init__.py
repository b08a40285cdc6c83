"""``repro_torch.checkpoint`` — npz checkpoints in the reference's on-disk
format (counterpart of ``repro/checkpoint``)."""
from repro_torch.checkpoint.io import (CheckpointCorruptError,  # noqa: F401
                                       checkpoint_metadata, load_checkpoint,
                                       load_experiment, save_checkpoint)
