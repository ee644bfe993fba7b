"""Checkpointing: ``.npz`` payloads + JSON index, async save, atomic commit
(fp training state and quantized serving trees), in the reference
package's on-disk layout."""
from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa: F401
                                                 CheckpointMetaError)
