"""Placement rules and the T-split aggregation (port of
``repro.sharding``)."""
from repro_torch.sharding.specs import (cache_pspecs,  # noqa: F401
                                        param_pspecs, to_shardings)
