"""The share of the run's decode steps that replayed a CUDA graph, %: the
program's counter ``serve.decode_graph{path=replay|capture|eager}``
(``repro_torch.models.decode_graph``), replays over all three paths, over
the whole run (warm-up, window and profiled steps). None where the
program has no such counter."""


def read(rec):
    try:
        from repro_torch.core import telemetry
        paths = telemetry.process().metrics.labeled("serve.decode_graph",
                                                    "path")
    except (ImportError, AttributeError):
        return None
    total = sum(paths.values())
    return 100.0 * paths.get("replay", 0) / total if total else None
