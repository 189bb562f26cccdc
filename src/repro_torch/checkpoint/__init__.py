"""Checkpoints in the JAX package's .ckpt layout."""
from repro_torch.checkpoint.store import (load_checkpoint,  # noqa: F401
                                          save_checkpoint)
