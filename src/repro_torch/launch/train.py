"""Federated training launcher (port of ``repro.launch.train``).

Two modes:
  sim  — the full FL-APU control plane: governance negotiation ->
         contract -> job -> pull-based rounds over the message board ->
         deployment, in one process (``repro_torch.core.Consortium``).
  pod  — the silo-stacked data plane: 2 silos, each leaf with a leading
         silo dim, with a FedAvg over the silo dim every ``--sync-every``
         steps (DiLoCo-style local SGD). In one process (no process
         group) both silos stack on one device and each silo's step runs
         on its own slice. Under ``torchrun`` (a world over 1, or any
         initialised group) it is the reference's run over a
         ``(pod, data, model)`` mesh of ranks (``--mesh``, default the
         reference's 2,2,2): every leaf a ``DTensor``, the silo dim over
         ``"pod"``, each pod training its own silos on its ``(data,
         model)`` sub-mesh, the FedAvg a collective over the pod group;
         nccl on the card, gloo with ``--device cpu``.

Runs on CUDA unless ``--device cpu`` is given. Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode sim \\
      --arch fedforecast-100m --rounds 3 --local-steps 5 --batch-size 4
  PYTHONPATH=src python -m repro_torch.launch.train --mode pod \\
      --arch fedforecast-100m --steps 8 --sync-every 4 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --mode pod --mesh 2,2,2 --device cpu              # 8 gloo ranks
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --mode pod --mesh 2,2,1                           # 4 cards, nccl
"""

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DEFAULT_DEVICE, resolve, synchronize

DOC = __doc__
N_PODS = 2


def run_sim(args, params=None, *, telemetry=None):
    """The sim mode; ``params`` (optional) is the server's initial global,
    else the server draws it from ``args.seed``; ``telemetry`` (optional)
    rides on the board. Returns the run report, the terminal phase,
    whether the metadata chain verifies, the consortium and the run's
    wall seconds."""
    from repro_torch.configs import get_config
    from repro_torch.core import Consortium, DataSchema
    from repro_torch.core.reporting import run_report
    from repro_torch.data import make_silo_datasets

    device = resolve(args.device)
    orgs = [f"org{i}" for i in range(args.silos)]
    con = Consortium(orgs, seed=args.seed, device=device,
                     initial_params=params, telemetry=telemetry)
    cfg = get_config(args.arch)
    cfg_r = cfg.reduced() if args.reduced else cfg
    schema = DataSchema(vocab=cfg_r.vocab, seq_len=args.seq_len)
    contract = con.negotiate({
        "arch": args.arch, "rounds": args.rounds,
        "local_steps": args.local_steps, "batch_size": args.batch_size,
        "lr": args.lr, "data_schema": schema.to_dict(),
        "secure_aggregation": not args.no_secure,
        "reduced": args.reduced,
    })
    job = con.server.job_creator.from_contract(contract)
    datasets = make_silo_datasets(args.silos, vocab=cfg_r.vocab,
                                  seq_len=args.seq_len, seed=args.seed)
    run_id = con.start(job, datasets)
    synchronize(device)
    t0 = time.perf_counter()
    phase = con.run_to_completion()
    synchronize(device)
    wall = time.perf_counter() - t0
    rep = run_report(con.server.metadata, run_id)
    print(f"run {run_id}: {phase} in {wall:.1f}s")
    print("loss curve:", [round(v, 4) for v in rep["loss_curve"]])
    print("contributions (r0):",
          rep["rounds"][0]["contributions"]["data_size"])
    chain = con.server.metadata.verify_chain()
    print("metadata chain ok:", chain)
    if phase != "done":
        raise RuntimeError(f"the run ended in {phase}, not done")
    return {"report": rep, "phase": phase, "chain_ok": chain,
            "consortium": con, "run_id": run_id, "wall_s": wall}


def pod_batch(rng: np.random.Generator, vocab: int, batch_size: int,
              seq_len: int, n_pods: int = N_PODS) -> np.ndarray:
    """One step's per-silo token batches, (n_pods, B, S) int32, drawn in
    the reference's order (silo 0 first)."""
    return np.stack([rng.integers(0, vocab, (batch_size, seq_len)) + 0
                     for _ in range(n_pods)]).astype(np.int32)


def run_pod(args, params=None, *, on_step=None):
    """The pod mode; ``params`` (optional) is the one-silo init that every
    silo starts from, else ``model.init`` from ``args.seed``.
    ``on_step(i, state)`` (optional) sees each step's inputs, the trained
    stack before any FedAvg and the params after it. Returns the final
    silo-stacked params and optimizer state, the per-silo losses of every
    step, and the seconds of every pod step and every FedAvg (host clock,
    the device synchronised). With a process group initialised the run
    is over ``args.mesh``'s ranks and the trees are ``DTensor``s."""
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import param_pspecs, to_shardings
    from repro_torch.sharding.specs import P, place
    from repro_torch.training import (fedavg_pod_params,
                                      make_multipod_train_step)
    from repro_torch.training.steps import stack_silos

    n_pods = N_PODS
    if dist.is_initialized():
        pod, data, model_ax = mesh_sizes(getattr(args, "mesh", None))
        mesh = make_host_mesh(data=data, model=model_ax, pod=pod)
        device = mesh.local_device
        if device.type != resolve(args.device).type:
            raise ValueError(f"the group's ranks are on {device.type}, "
                             f"not {args.device}")
    else:
        device = resolve(args.device)
        # the silos stack on the one visible device: a (pod, data, model)
        # descriptor of sizes 1 over it, so every spec places on that card
        mesh = make_host_mesh(data=1, model=1, pod=1, devices=[device])
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device)
    opt = adamw(args.lr)
    if params is None:
        params = model.init(model.generator(args.seed))
    params = _tree.tree_map(lambda a: torch.as_tensor(a).to(device), params)
    opt_state = opt.init(params)
    params = stack_silos([params] * n_pods)
    opt_state = stack_silos([opt_state] * n_pods)
    p_specs = _tree.tree_map(lambda s: P("pod", *s),
                             param_pspecs(model.abstract_params(), mesh))
    params = place(params, to_shardings(p_specs, mesh))
    if mesh.device_mesh is not None:
        # the moments follow their parameters' placement
        opt_state = dict(opt_state, **{
            k: place(opt_state[k], to_shardings(p_specs, mesh))
            for k in ("m", "v")})
        b_spec = to_shardings(P("pod", "data", None), mesh)
    step = make_multipod_train_step(model, opt, n_pods)
    rng = np.random.default_rng(args.seed)
    losses, step_s, fedavg_s = [], [], []
    say = not dist.is_initialized() or dist.get_rank() == 0
    for i in range(args.steps):
        toks = pod_batch(rng, cfg.vocab, args.batch_size, args.seq_len,
                         n_pods)
        batch = {"tokens": torch.from_numpy(toks).to(device)}
        if mesh.device_mesh is not None:
            batch = {"tokens": b_spec.place(batch["tokens"])}
        before = (params, opt_state)
        synchronize(device)
        t0 = time.perf_counter()
        trained, opt_state, metrics = step(params, opt_state, batch)
        synchronize(device)
        step_s.append(time.perf_counter() - t0)
        params = trained
        synced = (i + 1) % args.sync_every == 0
        if synced:
            t0 = time.perf_counter()
            params = fedavg_pod_params(trained)   # Model Aggregator
            synchronize(device)
            fedavg_s.append(time.perf_counter() - t0)
        loss = _whole(metrics["loss"]).cpu().numpy()
        losses.append(loss)
        if on_step is not None:
            on_step(i, {"before": before, "batch": batch,
                        "trained": trained, "params": params,
                        "metrics": metrics, "synced": synced})
        before = trained = None
        if say:
            print(f"step {i}: loss per silo = {loss.round(4)}"
                  f"{' (fedavg)' if synced else ''} ({step_s[-1]:.3f} s)")
    if say:
        print("pod-mode training complete")
    return {"params": params, "opt_state": opt_state,
            "losses": np.stack(losses), "step_s": step_s,
            "fedavg_s": fedavg_s, "mesh": mesh}


def _whole(x):
    """A ``DTensor``'s global value on every rank; a tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def mesh_sizes(text) -> tuple:
    """``"pod,data,model"`` (default the reference's ``2,2,2``) as three
    ints."""
    sizes = tuple(int(n) for n in (text or "2,2,2").split(","))
    if len(sizes) != 3 or min(sizes) < 1:
        raise ValueError(f"--mesh takes pod,data,model, got {text!r}")
    if N_PODS % sizes[0]:
        raise ValueError(f"{N_PODS} silos do not split over {sizes[0]} pods")
    return sizes


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags (the reference's, plus ``--device``)."""
    ap = argparse.ArgumentParser(
        description=DOC, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=["sim", "pod"], default="sim")
    ap.add_argument("--arch", default="fedforecast-100m")
    ap.add_argument("--silos", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-secure", action="store_true")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="use the full (non-reduced) architecture")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="2,2,2",
                    help="pod,data,model sizes of the pod mode's mesh of "
                         "ranks (under torchrun; their product is the "
                         "world size)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "sim":
        return run_sim(args)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return run_pod(args)
    # under torchrun: one rank of the mesh, its group from the env
    if resolve(args.device).type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if args.device != "cpu" else "gloo")
    try:
        return run_pod(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
