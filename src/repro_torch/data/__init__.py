from repro_torch.data.synthetic import (ForecastSiloDataset,  # noqa: F401
                                        SiloDataset, forecasting_series,
                                        make_silo_datasets, silo_key)
from repro_torch.data.pipeline import shard_batch  # noqa: F401
