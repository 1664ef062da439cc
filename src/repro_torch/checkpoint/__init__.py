from repro_torch.checkpoint.ckpt import (gc_checkpoints, latest_step,
                                         load_checkpoint, save_checkpoint,
                                         verify_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "gc_checkpoints", "verify_checkpoint"]
