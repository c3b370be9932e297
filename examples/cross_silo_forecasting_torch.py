"""The paper's scenario (FederatedForecasts) on the PyTorch port:
competing energy providers federately train a short-term production
forecaster without sharing data.

    PYTHONPATH=src python examples/cross_silo_forecasting_torch.py [--rounds N]
    PYTHONPATH=src python examples/cross_silo_forecasting_torch.py --device cpu

The same lifecycle as ``examples/cross_silo_forecasting.py``, through
``repro_torch``: governance negotiation of the data resolution, data
validation against the negotiated schema, secure-masked rounds with
FedAvgM, contribution measurement, per-silo personalization behind the
decision-maker's thresholds, monitoring after deployment and a 6-hour
forecast from each provider. What differs from the JAX example: the
model trains and serves on ``--device`` (CUDA unless asked for the CPU;
without CUDA the default raises), and the initial global is drawn from
the port's own seeded generator, so the loss curve, the deploy decisions
and the forecasts are not the JAX example's numbers. ``main`` returns
what it printed; the last line is the run's wall time and device.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import ClientConfig, Consortium, DataSchema  # noqa: E402
from repro_torch.core.reporting import (client_report,  # noqa: E402
                                        governance_report, run_report)
from repro_torch.data.synthetic import ForecastSiloDataset  # noqa: E402

PROVIDERS = ["nordwind-energie", "solarpark-rhein", "stadtwerke-ka"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=48,
                    help="forecast context window (hours)")
    ap.add_argument("--full", action="store_true",
                    help="run the full 100M forecaster (the production "
                    "profile)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    con = Consortium(PROVIDERS, seed=7, device=args.device)

    # --- governance: negotiate the time-series resolution + process -------
    # (hourly resolution -> seq_len=48 means 2 days of context)
    vocab = 4096 if args.full else 512
    schema = DataSchema(vocab=vocab, seq_len=args.seq_len,
                        value_ranges=(("mean_level", 0.0, float(vocab)),))
    contract = con.negotiate({
        "arch": "fedforecast-100m",
        "rounds": args.rounds,
        "local_steps": args.local_steps,
        "batch_size": 2,
        "lr": 1e-3,
        "data_schema": schema.to_dict(),
        "secure_aggregation": True,
        "outer_optimizer": "fedavgm",
        # --full: the 100M production forecaster (vocab 4096); default: the
        # reduced profile so the example finishes in seconds
        "reduced": not args.full,
    })
    print("== governance ==")
    for rec in governance_report(con.server.metadata)[:6]:
        print(f"  {rec['actor']:28s} {rec['operation']:18s}"
              f" {rec['subject']:12s} -> {rec['outcome']}")
    print(f"  ... contract {contract.contract_id}: "
          f"resolution seq_len={args.seq_len}, "
          f"rounds={args.rounds}, secure_agg=True")

    # --- federated run ------------------------------------------------------
    job = con.server.job_creator.from_contract(contract)
    datasets = [ForecastSiloDataset(p, seq_len=args.seq_len, vocab=vocab,
                                    seed=i, n_steps=20_000)
                for i, p in enumerate(PROVIDERS)]
    run_id = con.start(job, datasets,
                       client_config=ClientConfig(deploy_threshold=12.0,
                                                  monitor_threshold=14.0,
                                                  personalization_steps=2))
    phase = con.run_to_completion()
    rep = run_report(con.server.metadata, run_id)
    print(f"\n== run {run_id}: {phase} ==")
    print("  loss curve:", [round(l, 4) for l in rep["loss_curve"]])
    print("  contributions:",
          {k: round(v, 3)
           for k, v in rep["rounds"][-1]["contributions"]["data_size"].items()})

    # --- per-provider deployment + monitoring + forecast --------------------
    print("\n== providers ==")
    forecasts = {}
    for node, ds in zip(con.nodes, datasets):
        node.tick()                       # one monitoring cycle
        crep = client_report(node.metadata, node.client_id)
        status = ("deployed" if node.deployed_params is not None
                  else "rejected")
        context = ds.batch(1)["tokens"][:, :args.seq_len // 2]
        forecast = np.asarray(node.predict(context, n_steps=6)[0])
        name = ds.silo_id if hasattr(ds, "silo_id") else node.client_id
        forecasts[name] = forecast
        print(f"  {name}: {status}, {len(crep['trainings'])} trainings, "
              f"monitor={len(node.monitor_history)} evals, "
              f"6h forecast bins={forecast.tolist()}")
    chain_ok = con.server.metadata.verify_chain()
    print("\nmetadata chain intact:", chain_ok)
    print(f"wall {time.perf_counter() - t0:.2f} s on {_name(args.device)}")
    return {"phase": phase, "loss_curve": rep["loss_curve"],
            "forecasts": forecasts, "vocab": vocab, "chain_ok": chain_ok}


def _name(device) -> str:
    import torch
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


if __name__ == "__main__":
    main()
