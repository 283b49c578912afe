from repro_torch.checkpoint.store import (  # noqa: F401
    available_steps, restore, restore_latest, save)
