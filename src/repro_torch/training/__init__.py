from repro_torch.training.steps import make_train_step  # noqa: F401
