from repro_torch.checkpoint.ckpt import (gc_checkpoints, latest_step,
                                         restore_checkpoint, save_checkpoint,
                                         sweep_tmp)
from repro_torch.checkpoint.async_ckpt import (FAILPOINTS,
                                               AsyncCheckpointer,
                                               AsyncCheckpointError)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "gc_checkpoints", "sweep_tmp", "AsyncCheckpointer",
           "AsyncCheckpointError", "FAILPOINTS"]
