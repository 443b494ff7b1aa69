from repro_torch.checkpoint.io import latest_step, restore, save, step_dir

__all__ = ["latest_step", "restore", "save", "step_dir"]
