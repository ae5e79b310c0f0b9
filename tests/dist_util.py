"""gloo ranks on the CPU for the port's data- and sequence-parallel tests.

:func:`spawn` starts ``world`` processes (the spawn start method), joins
them into a gloo process group through a ``FileStore`` in a directory of
the caller's (no TCP port, so concurrent test workers cannot collide)
and runs one of the worker bodies below in each.  A worker writes its
results to ``out/rank<r>.pkl``; :func:`results` reads them back.

This module imports no JAX and nothing of ``beer_tpu``, so the spawned
processes import torch and the port only; the tests hold what the
workers wrote against the JAX package in their own process.
"""

from __future__ import annotations

import contextlib
import io
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _entry(rank, world, store, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp, *args) -> None:
    """``fn(rank, *args)`` on ``world`` gloo ranks; raises if one fails."""
    import torch.multiprocessing as mp

    store = Path(tmp) / "store"
    mp.start_processes(_entry, args=(world, str(store), fn, args), nprocs=world,
                       start_method="spawn")


def _dump(out, rank, value) -> None:
    with open(Path(out) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(value, fh)


def results(out, world: int) -> list:
    """What each rank's worker wrote, in rank order."""
    values = []
    for r in range(world):
        with open(Path(out) / f"rank{r}.pkl", "rb") as fh:
            values.append(pickle.load(fh))
    return values


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


# ----------------------------------------------------------------------
# beer_tpu_torch.parallel
# ----------------------------------------------------------------------
def build_model(case: dict):
    """The port's model of a case from its numpy dict (on the CPU)."""
    from beer_tpu_torch import convert

    build = {"HMM": convert.hmm_from_numpy, "Mixture": convert.mixture_from_numpy,
             "PhoneLoop": convert.phone_loop_from_numpy,
             "MixtureSet": convert.mixture_set_from_numpy}[case["model_type"]]
    return build(case["model"], device="cpu")


def build_graphs(case: dict):
    from beer_tpu_torch.models.graph import transcription_graphs

    return transcription_graphs(case["transcriptions"], case["n_phones"], case["states"],
                                dtype=torch.float64, shared=case["shared"], device="cpu")


def parallel_cases(rank, out, cases) -> None:
    """Every case of ``tests/test_torch_parallel.py`` through
    :mod:`beer_tpu_torch.parallel` on this rank: the ELBOs and the final
    model (``to_numpy``) of the training cases, the ELBO and statistics
    of the E-step case."""
    from beer_tpu_torch import parallel

    mesh = parallel.make_mesh(device="cpu")
    found = {}
    for name, case in cases.items():
        model = build_model(case)
        x, mask = _t(case["x"]), _t(case["mask"])
        kind = case["step"]
        elbos = []
        if kind == "train":
            step = parallel.make_vb_train_step(mesh)
            for _ in range(case["steps"]):
                elbo, model = step(model, x, mask)
                elbos.append(float(elbo))
        elif kind == "supervised":
            step = parallel.make_supervised_vb_train_step(mesh)
            graphs = build_graphs(case)
            for _ in range(case["steps"]):
                elbo, model = step(model, graphs, x, mask)
                elbos.append(float(elbo))
        elif kind == "minibatch":
            step = parallel.make_vb_minibatch_step(mesh)
            elbo, model = step(model, x, mask, case["datascale"])
            elbos.append(float(elbo))
        elif kind == "estep":
            elbo, acc = parallel.make_vb_estep(mesh)(model, x, mask)
            found[name] = {"elbos": [float(elbo)],
                           "acc": [a.numpy() for a in _leaves(acc["modelset"])]}
            continue
        found[name] = {"elbos": elbos, "model": model.to_numpy()}
    _dump(out, rank, found)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


# ----------------------------------------------------------------------
# beer_tpu_torch.ops.seq_parallel
# ----------------------------------------------------------------------
def seq_parallel_cases(rank, out, cases) -> None:
    """Every case of ``tests/test_torch_seq_parallel.py`` on this rank:
    ``make_sharded_forward`` / ``make_sharded_forward_backward`` on a 1-D
    ``seq`` mesh over every rank, or ``forward_backward_time_sharded`` on
    this rank's block of a ``("data", "seq")`` mesh of the case's
    ``mesh`` shape.  With one rank, any point-to-point exchange raises."""
    from torch.distributed.device_mesh import init_device_mesh

    from beer_tpu_torch.ops import seq_parallel

    world = dist.get_world_size()
    if world == 1:
        def no_p2p(*_):
            raise AssertionError("a point-to-point exchange on one rank")

        dist.batch_isend_irecv = no_p2p
    meshes = {None: init_device_mesh("cpu", (world,), mesh_dim_names=("seq",))}
    found = {}
    for name, case in cases.items():
        args = [_t(case[k]) for k in ("llh", "log_trans", "log_init", "log_final", "mask")]
        shape = case.get("mesh")
        if shape not in meshes:
            meshes[shape] = init_device_mesh("cpu", shape, mesh_dim_names=("data", "seq"))
        mesh = meshes[shape]
        if case["fn"] == "forward":
            found[name] = [a.numpy() for a in seq_parallel.make_sharded_forward(mesh)(*args)]
        elif shape is None:
            found[name] = [a.numpy()
                           for a in seq_parallel.make_sharded_forward_backward(mesh)(*args)]
        else:   # this rank's (data, seq) block through the in-shard function
            llh, lt, li, lf, mask = args
            d, s = mesh.get_local_rank("data"), mesh.get_local_rank("seq")
            nb, nt = llh.shape[0] // shape[0], llh.shape[1] // shape[1]
            rows, cols = slice(d * nb, (d + 1) * nb), slice(s * nt, (s + 1) * nt)
            _, _, log_z, post = seq_parallel.forward_backward_time_sharded(
                llh[rows, cols], lt, li, lf, mask[rows, cols], mesh, "seq")
            found[name] = {"rows": (rows.start, rows.stop), "cols": (cols.start, cols.stop),
                           "log_z": log_z.numpy(), "posteriors": post.numpy()}
    _dump(out, rank, found)


# ----------------------------------------------------------------------
# hmm train through the CLI
# ----------------------------------------------------------------------
def cli_runs(rank, out, runs) -> None:
    """``beer-torch`` on each command line of ``runs`` (name → argv) on
    this rank; its printed lines are the rank's result."""
    from beer_tpu_torch.cli.main import main as cli

    printed = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        if rc:
            raise RuntimeError(f"{argv} returned {rc}")
        printed[name] = buf.getvalue()
    _dump(out, rank, printed)
