from repro_torch.checkpoint.io import (RowBlocks, latest_step, restore, save,
                                      step_dir)

__all__ = ["RowBlocks", "latest_step", "restore", "save", "step_dir"]
