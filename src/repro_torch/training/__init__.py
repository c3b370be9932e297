from repro_torch.training.steps import (fedavg_pod_params,  # noqa: F401
                                        make_fedavg_pod_step,
                                        make_multipod_train_step,
                                        make_train_step)
