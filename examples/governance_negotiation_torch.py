"""Governance negotiation walkthrough (paper §VII Governance) on the
PyTorch port.

    PYTHONPATH=src python examples/governance_negotiation_torch.py               # card
    PYTHONPATH=src python examples/governance_negotiation_torch.py --device cpu  # CPU

The same decision lifecycle as ``examples/governance_negotiation.py``,
through ``repro_torch``'s copies of the Governance Cockpit and the
metadata store: proposals, rejection, counter-proposal, supersession,
contract versioning, and the provenance trail that makes every decision
traceable. What differs from the JAX example: nothing in the trail (the
cockpit has no model and no tensor); ``--device`` is checked as every
entry point of the port checks it, so without CUDA the default raises,
``main`` returns the store and the cockpit, and the last line is
the run's wall time and device.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.governance import GovernanceCockpit  # noqa: E402
from repro_torch.core.metadata import MetadataStore  # noqa: E402
from repro_torch.core.reporting import governance_report  # noqa: E402
from repro_torch.device import resolve  # noqa: E402

PARTICIPANTS = ["windco", "solarx", "gridpower"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    dev = resolve(args.device)
    md = MetadataStore()
    cockpit = GovernanceCockpit(PARTICIPANTS, md)

    # windco wants aggressive training; solarx rejects the learning rate
    p_rounds = cockpit.propose("windco", "rounds", 10,
                               rationale="more rounds -> better model")
    p_lr = cockpit.propose("windco", "lr", 1e-2,
                           rationale="faster convergence")
    for u in ("solarx", "gridpower"):
        cockpit.vote(u, p_rounds.proposal_id, True)
    cockpit.vote("solarx", p_lr.proposal_id, False)   # too unstable
    print(f"rounds proposal: {p_rounds.status}; lr proposal: {p_lr.status}")

    # counter-proposal from solarx, informed by their model experience
    p_lr2 = cockpit.propose("solarx", "lr", 1e-3,
                            rationale="stable on our non-IID silo data")
    for u in ("windco", "gridpower"):
        cockpit.vote(u, p_lr2.proposal_id, True)

    # also negotiate an explainable aggregation strategy
    p_agg = cockpit.propose("gridpower", "aggregation", "trimmed_mean",
                            rationale="robust to a faulty provider feed")
    p_sec = cockpit.propose("gridpower", "secure_aggregation", False,
                            rationale="trimmed_mean needs plaintext updates")
    for p in (p_agg, p_sec):
        for u in ("windco", "solarx"):
            cockpit.vote(u, p.proposal_id, True)

    contract = cockpit.finalize()
    print(f"\ncontract v{contract.version} ({contract.contract_id}):")
    for k in ("rounds", "lr", "aggregation", "secure_aggregation"):
        print(f"  {k:20s} = {contract.decisions[k]}")

    # a new negotiation supersedes decisions, bumping the version
    cockpit.request_new_negotiation("windco", "expand to 2024 data")
    p = cockpit.propose("windco", "rounds", 20)
    for u in ("solarx", "gridpower"):
        cockpit.vote(u, p.proposal_id, True)
    c2 = cockpit.finalize()
    print(f"\nrenegotiated: contract v{c2.version}, "
          f"rounds={c2.decisions['rounds']}")

    print(f"\nprovenance trail ({len(governance_report(md))} records, "
          f"chain intact={md.verify_chain()}):")
    for rec in governance_report(md):
        print(f"  #{rec['seq']:2d} {rec['actor']:10s} "
              f"{rec['operation']:20s} {str(rec['subject']):18s} "
              f"-> {rec['outcome']}")
    print(f"\nwall {time.perf_counter() - t0:.2f} s on {_name(dev)}")
    return md, cockpit


def _name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


if __name__ == "__main__":
    main()
