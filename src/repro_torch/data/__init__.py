from repro_torch.data.synthetic import (ForecastSiloDataset,  # noqa: F401
                                        SiloDataset, forecasting_series,
                                        make_silo_datasets, silo_key)
