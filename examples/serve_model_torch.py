"""Model Subscription API on the PyTorch port: an external application
consuming predictions (paper §IV "external system" + SAAM task 40).

    PYTHONPATH=src python examples/serve_model_torch.py               # card
    PYTHONPATH=src python examples/serve_model_torch.py --device cpu  # CPU

The same run as ``examples/serve_model.py``, through ``repro_torch``:
trains a tiny federated model, then serves batched inference requests
through the deployed client's Inference Manager, and the monitoring loop
watches the deployed model's quality. What differs from the JAX example:
the model trains and serves on ``--device`` (CUDA unless asked for the
CPU; without CUDA the default raises), and the initial global is drawn
from the port's own seeded generator, so its losses and continuations
are not the JAX example's. ``main`` returns what it printed; the last
line is the run's wall time and device.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import ClientConfig, Consortium, DataSchema  # noqa: E402
from repro_torch.data import make_silo_datasets  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    con = Consortium(["windco", "solarx"], seed=3, device=args.device)
    schema = DataSchema(vocab=512, seq_len=32)
    contract = con.negotiate({
        "arch": "fedforecast-100m", "rounds": 2, "local_steps": 2,
        "batch_size": 2, "data_schema": schema.to_dict()})
    job = con.server.job_creator.from_contract(contract)
    datasets = make_silo_datasets(2, vocab=512, seq_len=32, seed=3)
    run_id = con.start(job, datasets,
                       client_config=ClientConfig(personalization_steps=1))
    phase = con.run_to_completion()
    node = con.nodes[0]
    print(f"run {run_id}: {phase}; deployed={node.deployed_digest[:12]}")

    # --- the external application sends batched inference requests --------
    rng = np.random.default_rng(0)
    predictions = []
    for req_id in range(3):
        batch = rng.integers(0, 512, (4, 16)).astype(np.int32)  # 4 requests
        preds = node.predict(batch, n_steps=4)
        predictions.append(np.asarray(preds))
        print(f"request batch {req_id}: {batch.shape[0]} prompts -> "
              f"continuations {np.asarray(preds).tolist()}")

    # --- model monitoring keeps evaluating the deployed model --------------
    for _ in range(3):
        node.tick()
    evals = [round(h["eval_loss"], 3) for h in node.monitor_history]
    print("monitoring evals:", evals)
    print("admin notifications:", node.notifications or "none")
    print(f"wall {time.perf_counter() - t0:.2f} s on {_name(args.device)}")
    return {"phase": phase, "predictions": predictions, "evals": evals,
            "chain_ok": con.server.metadata.verify_chain()}


def _name(device) -> str:
    import torch
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


if __name__ == "__main__":
    main()
