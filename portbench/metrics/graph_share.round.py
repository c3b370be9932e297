"""The share of the run's silo train steps that replayed a CUDA graph, %:
the program's counter ``train.step_graph{path=replay|capture|eager}``
(``repro_torch.training.train_graph``), replays over all three paths,
over the whole run (warm-up, window and profiled round). None where the
program has no such counter."""


def read(rec):
    try:
        from repro_torch.core import telemetry
        paths = telemetry.process().metrics.labeled("train.step_graph",
                                                    "path")
    except (ImportError, AttributeError):
        return None
    total = sum(paths.values())
    return 100.0 * paths.get("replay", 0) / total if total else None
