from repro_torch.checkpoint.store import (CheckpointManager, restore_blocks,
                                          restore_tree, save_tree)

__all__ = ["CheckpointManager", "restore_blocks", "restore_tree",
           "save_tree"]
