from repro_torch.checkpoint.checkpointer import as_train_state, restore_pytree, save_pytree, tree_paths
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "as_train_state", "restore_pytree", "save_pytree", "tree_paths"]
