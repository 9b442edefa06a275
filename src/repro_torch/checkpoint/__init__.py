from repro_torch.checkpoint.checkpointer import (Checkpointer, save_pytree,
                                                 load_pytree)

__all__ = ["Checkpointer", "save_pytree", "load_pytree"]
