from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
