from repro_torch.checkpoint.checkpoint import (
    save_checkpoint, restore_checkpoint, latest_step, CheckpointManager)
