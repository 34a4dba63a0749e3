from .checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_checkpoint_arrays,
    restore_checkpoint,
    save_checkpoint,
)
