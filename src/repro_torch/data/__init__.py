from repro_torch.data.synthetic import (SiloDataset,  # noqa: F401
                                        make_silo_datasets, silo_key)
