"""Quickstart on the PyTorch port: a 3-company cross-silo FL run.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # CPU
    ... --device cpu --protocol async_buff                # FedBuff commits
    ... --device cpu --devices-per-silo 1000 --device-cohort-size 4

The same FL-APU lifecycle as ``examples/quickstart.py``, through
``repro_torch``: negotiate -> contract -> job -> validate -> secure-masked
rounds -> deploy -> inference. ``--protocol async_buff`` runs the
buffered asynchronous protocol instead (secure aggregation off, which it
requires; 2 folds a commit). ``--devices-per-silo`` puts a simulated
device fleet behind each silo, ``--device-cohort-size`` devices of it
training each round (the hierarchical tier; sync only). It runs on CUDA
unless asked for the CPU (without CUDA the default raises). The initial
global is drawn from the port's own seeded generator, so its numbers are
not the JAX quickstart's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import Consortium, DataSchema  # noqa: E402
from repro_torch.core.reporting import run_report  # noqa: E402
from repro_torch.data import make_silo_datasets  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--protocol", default="sync",
                    choices=["sync", "async_buff"])
    ap.add_argument("--devices-per-silo", type=int, default=1)
    ap.add_argument("--device-cohort-size", type=int, default=0)
    args = ap.parse_args(argv)
    asynchronous = args.protocol == "async_buff"

    # 1. three competing companies + a trusted coordinator
    con = Consortium(["windco", "solarx", "gridpower"], seed=0,
                     device=args.device)

    # 2. participants negotiate the FL process (data format + hyperparams)
    schema = DataSchema(vocab=512, seq_len=32)
    contract = con.negotiate({
        "arch": "fedforecast-100m",
        "rounds": 3, "local_steps": 3, "batch_size": 4, "lr": 1e-3,
        "data_schema": schema.to_dict(),
        "secure_aggregation": not asynchronous,
        "protocol": args.protocol, "async_buffer_size": 2,
        "devices_per_silo": args.devices_per_silo,
        "device_cohort_size": args.device_cohort_size,
    })
    print(f"contract {contract.contract_id} v{contract.version} agreed by "
          f"{len(contract.participants)} participants")

    # 3. governance contract -> FL Job -> pull-based federated run
    job = con.server.job_creator.from_contract(contract)
    datasets = make_silo_datasets(3, vocab=512, seq_len=32, seed=1)
    run_id = con.start(job, datasets)
    phase = con.run_to_completion()

    # 4. report (what the Governance & Management Website shows)
    rep = run_report(con.server.metadata, run_id)
    print(f"run {run_id}: {phase}")
    for r in rep["rounds"]:
        print(f"  round {r['round']}: "
              f"loss={r['metrics']['mean_train_loss']:.4f} "
              f"model={r['model_digest'][:12]} contrib="
              f"{ {k: round(v, 2) for k, v in r['contributions']['data_size'].items()} }")

    for n in con.nodes:
        for rec in n.metadata.query(operation="inner_round"):
            d = rec["details"]
            print(f"  {n.client_id} inner round {d['round']}: sampled "
                  f"{d['sampled']}, dropped {d['dropped']}, folded "
                  f"{d['folded']}, {d['devices_per_sec']:.1f} devices/s")

    # 5. every client personalized + deployed; external app queries it
    node = con.nodes[0]
    prompt = datasets[0].batch(1)["tokens"][:, :16]
    print("deployed digest:", node.deployed_digest[:12])
    print("prediction:", node.predict(prompt, n_steps=5)[0].tolist())
    print("metadata chain intact:", con.server.metadata.verify_chain())


if __name__ == "__main__":
    main()
