from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    LAUNCHES, flash_attention, reset_launches)
