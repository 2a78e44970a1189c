from .checkpoint import latest_step, prune, restore, restore_arrays, save

__all__ = ["latest_step", "prune", "restore", "restore_arrays", "save"]
