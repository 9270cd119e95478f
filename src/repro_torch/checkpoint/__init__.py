"""repro_torch.checkpoint — atomic checkpoints in the reference's format."""
from .checkpointer import Checkpointer, load_pytree, save_pytree

__all__ = ["Checkpointer", "save_pytree", "load_pytree"]
