"""Worlds of ranks for the port's mesh tests, and the checks of the
world itself.

``run_world(fn, world, tmp_path, *args)`` spawns ``world`` processes,
each a rank of a gloo group initialised from a ``FileStore`` under
``tmp_path`` (no TCP port to race for under xdist) with one torch thread,
runs ``fn(rank, world, *args)`` in each and returns every rank's result
(anything ``torch.save`` keeps). A module-scoped fixture of a test file
runs all of that file's checks in one world, so each world is spawned
once a file. This module imports neither jax nor the JAX package: the
ranks import it to find their functions, and stay light.

The checks here: a DTensor matmul over a (2, 2) mesh equals the whole
product, and a reduce-scatter over the group sums the ranks' inputs.
"""
import os
import traceback

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, init_file, out_dir, args):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_ranks
    init_ranks("gloo", world, rank, init_file)
    try:
        out = {"ok": fn(rank, world, *args)}
    except Exception:  # noqa: BLE001 — carried to the parent's assert
        out = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_world(fn, world: int, tmp_path, *args) -> list:
    """``[fn(0, world, *args), ...]`` from ``world`` gloo ranks."""
    out_dir = os.fspath(tmp_path)
    init_file = os.path.join(out_dir, "store")
    mp.start_processes(_entry, args=(fn, world, init_file, out_dir, args),
                       nprocs=world, start_method="spawn", join=True)
    results = []
    for rank in range(world):
        got = torch.load(os.path.join(out_dir, f"rank{rank}.pt"),
                         weights_only=False)
        if "error" in got:
            raise AssertionError(f"rank {rank} failed:\n{got['error']}")
        results.append(got["ok"])
    return results


def _world_checks(rank, world):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.specs import NamedSharding, P
    mesh = make_host_mesh(2, 2)
    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 6, generator=g)
    b = torch.randn(6, 4, generator=g)
    da = NamedSharding(mesh, P("data", None)).place(a)
    db = NamedSharding(mesh, P(None, "model")).place(b)
    prod = (da @ db).full_tensor()
    x = torch.full((world * 3,), float(rank + 1))
    out = torch.empty(3)
    dist.reduce_scatter_tensor(out, x)
    return {"matmul_err": float((prod - a @ b).abs().max()),
            "placements": tuple(da.placements) == (Shard(0), Replicate()),
            "local": tuple(da.to_local().shape), "rs": out.tolist()}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(_world_checks, 4, tmp_path_factory.mktemp("world4"))


def test_dtensor_matmul_over_a_2x2_world_is_exact(world4):
    for r in world4:
        assert r["matmul_err"] == 0.0
        assert r["placements"]
        assert r["local"] == (4, 6)


def test_reduce_scatter_sums_the_ranks(world4):
    for r in world4:
        assert r["rs"] == [10.0] * 3
