"""Architecture configs the port runs. Importing registers each one."""
from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      register)
from repro_torch.configs import fedforecast_100m, hymba_1p5b  # noqa: F401
