from repro_torch.optim.adamw import (Optimizer, adamw,  # noqa: F401
                                     apply_updates, clip_by_global_norm,
                                     cosine_schedule, sgd)
from repro_torch.optim.outer import (OUTER_REGISTRY,  # noqa: F401
                                     OuterOptimizer, fedadam, fedavg,
                                     fedavgm)
