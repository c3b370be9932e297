from repro_torch.kernels.secure_agg.ops import (  # noqa: F401
    LAUNCHES, masked_sum, masked_sum_corrected)
