from repro_torch.checkpoint.ckpt import (load_checkpoint, save_checkpoint,
                                         pytree_digest)  # noqa: F401
