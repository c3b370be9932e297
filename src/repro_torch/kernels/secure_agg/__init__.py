from repro_torch.kernels.secure_agg.ops import (  # noqa: F401
    LAUNCHES, combine_pytrees, masked_sum, masked_sum_corrected,
    secure_agg_combine)
