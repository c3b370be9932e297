"""Architecture configs. Importing this package registers every arch: the
reference's eleven (``repro.configs``) and the port's own
``PORT_ONLY_ARCHS``."""
from repro_torch.configs.base import (FrontendConfig, MLAConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, SSMConfig,
                                      get_config, list_configs, register)
from repro_torch.configs.shapes import (SHAPES, InputShape,  # noqa: F401
                                        get_shape, shape_applicable)

# side-effect registration: one module per architecture
from repro_torch.configs import mamba2_780m            # noqa: F401
from repro_torch.configs import seamless_m4t_large_v2  # noqa: F401
from repro_torch.configs import command_r_plus_104b    # noqa: F401
from repro_torch.configs import gemma2_9b              # noqa: F401
from repro_torch.configs import olmoe_1b_7b            # noqa: F401
from repro_torch.configs import hymba_1p5b             # noqa: F401
from repro_torch.configs import gemma3_4b              # noqa: F401
from repro_torch.configs import internvl2_2b           # noqa: F401
from repro_torch.configs import dbrx_132b              # noqa: F401
from repro_torch.configs import minicpm3_4b            # noqa: F401
from repro_torch.configs import fedforecast_100m       # noqa: F401
from repro_torch.configs import nemotron_3_nano_30b_a3b  # noqa: F401

ASSIGNED_ARCHS = (
    "mamba2-780m", "seamless-m4t-large-v2", "command-r-plus-104b",
    "gemma2-9b", "olmoe-1b-7b", "hymba-1.5b", "gemma3-4b",
    "internvl2-2b", "dbrx-132b", "minicpm3-4b",
)

# registered here and not in the reference
PORT_ONLY_ARCHS = ("nemotron-3-nano-30b-a3b",)
