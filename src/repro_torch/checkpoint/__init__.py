from repro_torch.checkpoint.ckpt import pytree_digest  # noqa: F401
