from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    LAUNCHES, reset_launches, ssd_scan)
