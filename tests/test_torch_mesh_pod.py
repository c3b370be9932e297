"""The pod run and its FedAvg over a (pod, data, model) mesh of ranks
against the port's one-process run and the JAX package's run over 8
host devices.

* The reference: ``repro.launch.train.run_pod``'s loop (the (2, 2, 2)
  host mesh, the silo-stacked ``P("pod", ...)`` placement, the jitted
  ``make_multipod_train_step`` and ``fedavg_pod_params``) on reduced
  ``fedforecast-100m``, 8 steps of 4 x 64, FedAvg every 4, in a
  subprocess with 8 forced host devices, as ``tests/test_dryrun_small.py``
  runs it; it also writes its init, which both port runs take, and the
  collectives of its compiled FedAvg of a (2, 64, 64) f32 leaf at
  ``P("pod", "data", "model")`` (``analyze_collectives``, pod size 4).
* The port over 8 gloo ranks (``run_pod`` with a process group up,
  ``--mesh 2,2,2``): every loss within 1e-5 of the port's one-process
  ``run_pod`` and every param within 1e-4; both within 1e-4 of the
  reference (the twin rule at lr 3e-4).
* ``fedavg_pod_params`` over the pod group on random stacks: the mean
  bitwise equal to the one-process mean, the weighted mean within one f32
  ulp; ``make_fedavg_pod_step(quantize=True)`` (with and without the
  reference's ``pspecs``) bitwise equal to the one-process int8 step;
  the one-process int8 step with ``pspecs`` equal to the reference's.
* ``record_collectives``: the per-silo step issues no cross-pod byte;
  the FedAvg of the (2, 64, 64) leaf moves exactly the reference's
  ``dcn_bytes``.
"""
import argparse
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_mesh_world import run_world

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.hlo_analysis import analyze_collectives
    from repro.launch.mesh import make_host_mesh
    from repro.models import build_model
    from repro.optim import adamw
    from repro.sharding import param_pspecs
    from repro.training import fedavg_pod_params, make_multipod_train_step
    out_dir = sys.argv[1]
    steps, sync_every, batch, seq, lr, seed = 8, 4, 4, 64, 3e-4, 0
    n_pods = 2
    mesh = make_host_mesh(data=2, model=2, pod=n_pods)
    cfg = get_config("fedforecast-100m").reduced()
    model = build_model(cfg)
    opt = adamw(lr)
    params = model.init(jax.random.PRNGKey(seed))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    np.savez(os.path.join(out_dir, "init.npz"), **{
        jax.tree_util.keystr(k): np.asarray(v) for k, v in flat})
    opt_state = opt.init(params)
    stack = lambda t: jax.tree.map(lambda a: jnp.stack([a] * n_pods), t)
    params, opt_state = stack(params), stack(opt_state)
    p_specs = jax.tree.map(lambda s: P("pod", *tuple(s)),
                           param_pspecs(model.abstract_params(), mesh),
                           is_leaf=lambda x: isinstance(x, P))
    shd = lambda t, specs: jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), t, specs,
        is_leaf=lambda x: hasattr(x, "shape"))
    losses = []
    with mesh:
        params = shd(params, p_specs)
        opt_state = shd(opt_state, param_pspecs(opt_state, mesh))
        step = jax.jit(make_multipod_train_step(model, opt, n_pods))
        fedavg = jax.jit(fedavg_pod_params)
        rng = np.random.default_rng(seed)
        for i in range(steps):
            toks = np.stack([rng.integers(0, cfg.vocab, (batch, seq)) + 0
                             for _ in range(n_pods)]).astype(np.int32)
            params, opt_state, metrics = step(params, opt_state,
                                              {"tokens": jnp.asarray(toks)})
            if (i + 1) % sync_every == 0:
                params = fedavg(params)
            losses.append(np.asarray(metrics["loss"]).tolist())
        leaf = {"w": jax.ShapeDtypeStruct((2, 64, 64), jnp.float32)}
        sh = {"w": NamedSharding(mesh, P("pod", "data", "model"))}
        c = jax.jit(fedavg_pod_params, in_shardings=(sh,),
                    out_shardings=sh).lower(leaf).compile()
    coll = analyze_collectives(c.as_text(), n_devices=8, pod_size=4)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    np.savez(os.path.join(out_dir, "final.npz"), **{
        jax.tree_util.keystr(k): np.asarray(v) for k, v in flat})
    print("RESULT" + json.dumps({"losses": losses,
                                 "fedavg_dcn": coll["dcn_bytes"],
                                 "fedavg_count": coll["count"]}))
""")


def _args(**kw):
    base = dict(mode="pod", arch="fedforecast-100m", silos=3, rounds=3,
                local_steps=5, steps=8, sync_every=4, batch_size=4,
                seq_len=64, lr=3e-4, seed=0, no_secure=False, reduced=True,
                device="cpu", mesh="2,2,2")
    return argparse.Namespace(**{**base, **kw})


def _init_tree(path):
    """The reference's init (keys like ``['stack']['wq']``) as the port's
    nested dict of tensors."""
    from repro_torch.convert import params_from_numpy
    tree = {}
    with np.load(path) as z:
        for key, value in z.items():
            parts = [p.strip("'\"") for p in key.strip("[]").split("][")]
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
    return params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("reference_pod")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(out_dir)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    res = json.loads(line[0][len("RESULT"):])
    res["init"] = str(out_dir / "init.npz")
    res["final"] = _init_tree(out_dir / "final.npz")
    return res


def _stacks(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(2, 8, 12, generator=g),
            "b": torch.randn(2, 5, generator=g)}


def _rank_run(rank, world, init_path):
    import torch.distributed as dist
    from repro_torch import tree as _tree
    from repro_torch.launch import train
    from repro_torch.launch.hlo_analysis import record_collectives
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import to_shardings
    from repro_torch.sharding.specs import P, place
    from repro_torch.training import (fedavg_pod_params,
                                      make_fedavg_pod_step)

    out = {}
    steps = []

    def on_step(i, st):
        if i == 0:                      # one per-silo step, recorded
            steps.append((st["before"], st["batch"]))

    run = train.run_pod(_args(), _init_tree(init_path), on_step=on_step)
    out["losses"] = run["losses"]
    if rank == 0:
        out["params"] = _tree.tree_map(lambda a: a.full_tensor(),
                                       run["params"])
    else:
        _tree.tree_map(lambda a: a.full_tensor(), run["params"])
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import make_multipod_train_step
    model = build_model(get_config("fedforecast-100m").reduced(),
                        device="cpu")
    step = make_multipod_train_step(model, adamw(3e-4), 2)
    (params, opt_state), batch = steps[0]
    with record_collectives(pod_size=4) as rec:
        step(params, opt_state, batch)
    out["step_coll"] = rec.summary()

    mesh = make_host_mesh(2, 2, pod=2)
    specs = {"w": P("pod", "data", "model"), "b": P("pod", None)}
    sh = to_shardings(specs, mesh)
    for seed in (0, 1):
        stacks = _stacks(seed)
        placed = place(stacks, sh)
        w = torch.tensor([3.0, 1.0])
        for tag, fn in (
                ("mean", lambda t: fedavg_pod_params(t)),
                ("weighted", lambda t: fedavg_pod_params(t, weights=w)),
                ("q8", make_fedavg_pod_step(quantize=True)),
                ("q8_pspecs", make_fedavg_pod_step(quantize=True,
                                                   pspecs=specs))):
            got = fn(placed)
            whole = {k: v.full_tensor() for k, v in got.items()}
            out[f"{tag}{seed}"] = {
                "placements_kept": all(
                    tuple(got[k].placements) == tuple(placed[k].placements)
                    for k in got),
                **{k: v.numpy() for k, v in whole.items()}}
    big = place({"w": torch.randn(2, 64, 64)},
                to_shardings({"w": P("pod", "data", "model")}, mesh))
    with record_collectives(pod_size=4) as rec:
        fedavg_pod_params(big)
    out["fedavg_coll"] = rec.summary()
    out["world"] = dist.get_world_size()
    return out


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    return run_world(_rank_run, 8, tmp_path_factory.mktemp("pod"),
                     reference["init"])


@pytest.fixture(scope="module")
def one_process(reference):
    from repro_torch.launch import train
    torch.set_num_threads(1)
    return train.run_pod(_args(), _init_tree(reference["init"]))


def _pairs(a, b):
    from repro_torch import tree as _tree
    return zip(_tree.leaves(a), _tree.leaves(b))


def test_pod_run_over_8_ranks_matches_one_process(world, one_process):
    assert world[0]["world"] == 8
    for r in world:
        np.testing.assert_allclose(r["losses"], one_process["losses"],
                                   atol=LOSS_TOL, rtol=0)
    for a, b in _pairs(world[0]["params"], one_process["params"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PARAM_TOL,
                                   rtol=0)


def test_pod_run_over_8_ranks_matches_the_reference_on_8_devices(
        world, reference):
    assert np.asarray(world[0]["losses"]).shape == (8, 2)
    np.testing.assert_allclose(world[0]["losses"], reference["losses"],
                               atol=PARAM_TOL, rtol=0)
    for a, b in _pairs(world[0]["params"], reference["final"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PARAM_TOL,
                                   rtol=0)


def test_pod_run_ends_on_a_fedavg(world):
    from repro_torch import tree as _tree
    for leaf in _tree.leaves(world[0]["params"]):
        assert torch.equal(leaf[0], leaf[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_fedavg_over_the_pod_group(world, seed):
    from repro_torch.training import (fedavg_pod_params,
                                      make_fedavg_pod_step)
    stacks = _stacks(seed)
    w = torch.tensor([3.0, 1.0])
    mean = fedavg_pod_params(stacks)
    weighted = fedavg_pod_params(stacks, weights=w)
    q8 = make_fedavg_pod_step(quantize=True)(stacks)
    for r in world:
        for k in stacks:
            assert np.array_equal(r[f"mean{seed}"][k], mean[k].numpy())
            np.testing.assert_array_max_ulp(r[f"weighted{seed}"][k],
                                            weighted[k].numpy(), maxulp=1)
            assert np.array_equal(r[f"q8{seed}"][k], q8[k].numpy())
            assert np.array_equal(r[f"q8_pspecs{seed}"][k], q8[k].numpy())
        for tag in ("mean", "weighted", "q8", "q8_pspecs"):
            assert r[f"{tag}{seed}"]["placements_kept"], tag


def test_quantized_step_takes_the_reference_pspecs():
    """One process, no mesh: ``pspecs`` place nothing, as the reference's
    constraint without a mesh in scope; the int8 means agree with the
    reference's within its quantization step's rounding (1e-6)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from repro.training import make_fedavg_pod_step as jstep
    from repro_torch.sharding.specs import P
    from repro_torch.training import make_fedavg_pod_step
    stacks = _stacks(2)
    tspecs = {"w": P("pod", "data", "model"), "b": P("pod", None)}
    jspecs = {"w": JP("pod", "data", "model"), "b": JP("pod", None)}
    got = make_fedavg_pod_step(quantize=True, pspecs=tspecs)(stacks)
    plain = make_fedavg_pod_step(quantize=True)(stacks)
    ref = jstep(quantize=True, pspecs=jspecs)(
        {k: jnp.asarray(v.numpy()) for k, v in stacks.items()})
    for k in stacks:
        assert torch.equal(got[k], plain[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6, rtol=0)


def test_the_silo_step_crosses_no_pod(world):
    for r in world:
        coll = r["step_coll"]
        assert coll["count"] > 0 and coll["ici_bytes"] > 0
        assert coll["dcn_bytes"] == 0
        assert not any(op["cross_pod"] for op in coll["ops"])


def test_fedavg_moves_the_reference_dcn_bytes(world, reference):
    assert reference["fedavg_dcn"] > 0
    for r in world:
        coll = r["fedavg_coll"]
        assert coll["dcn_bytes"] == reference["fedavg_dcn"]
        assert coll["count"] == reference["fedavg_count"]
        assert all(op["cross_pod"] and op["group_size"] == 2
                   for op in coll["ops"])
