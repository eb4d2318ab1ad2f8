from repro_torch.checkpoint.io import (  # noqa: F401
    all_checkpoints, latest_checkpoint, load_checkpoint, load_latest,
    save_checkpoint)
