"""The port's sequence-parallel inference (``beer_tpu_torch.ops.seq_parallel``)
on gloo ranks on the CPU.

The cases of ``tests/test_seq_parallel.py`` run once on 4 gloo ranks
(``dist_util.seq_parallel_cases``, a module fixture) and the same numpy
inputs (from a seed) go through the JAX package's ``make_sharded_*`` /
``forward_backward_time_sharded`` on its 8-device CPU mesh and through
the port's unsharded ``semiring_scan.forward_backward``:

* forward (4 seq ranks): log α on every valid frame and log Z, rtol 1e-8;
* forward-backward (4 seq ranks): log Z rtol 1e-8, log β rtol 1e-7 /
  atol 1e-8, posteriors rtol 1e-6 / atol 1e-9;
* a 2 × 2 ``("data", "seq")`` mesh, each rank its block through
  ``forward_backward_time_sharded``: log Z and posteriors as above;
* the bench shape (a 50 × 3 phone loop, S = 150, B = 8, T = 200) on 4
  seq ranks, with lengths inside the blocks, on their boundaries and one
  block wholly masked;
* a sparse phone-loop graph (forbidden arcs) with a padded tail;
* one rank (world size 1): no point-to-point exchange runs, and the
  result equals the unsharded one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from beer_tpu import parallel as jparallel
from beer_tpu.models import graph as jgraph
from beer_tpu.ops import seq_parallel as jsp
from beer_tpu_torch.ops import semiring_scan
from dist_util import results, seq_parallel_cases, spawn
from port_util import close

WORLD = 4


def _hmm_params(rng, s):
    trans = rng.uniform(0.1, 1.0, size=(s, s))
    init = rng.uniform(0.1, 1.0, size=s)
    return (np.log(trans / trans.sum(1, keepdims=True)), np.log(init / init.sum()),
            np.log(rng.uniform(0.1, 1.0, size=s)))


def _case(fn, llh, params, lengths=None, mask=None, mesh=None):
    if mask is None:
        t_len = llh.shape[1]
        mask = (np.arange(t_len)[None] < np.asarray(lengths)[:, None]).astype(np.float64)
    lt, li, lf = params
    return dict(fn=fn, llh=llh, log_trans=lt, log_init=li, log_final=lf, mask=mask, mesh=mesh)


def _cases():
    rng = np.random.default_rng(42)
    cases = {"forward": _case("forward", rng.normal(size=(3, 64, 5)), _hmm_params(rng, 5),
                              lengths=[64, 40, 21]),
             "forward_backward": _case("forward_backward", rng.normal(size=(2, 64, 4)),
                                       _hmm_params(rng, 4), lengths=[64, 30]),
             "mesh_2x2": _case("forward_backward", rng.normal(size=(4, 32, 4)),
                               _hmm_params(rng, 4), lengths=[32, 20, 9, 28], mesh=(2, 2))}
    cg = jgraph.phone_loop_graph(50, 3).compile(jnp.float64)
    loop = tuple(np.asarray(a) for a in (cg.log_trans, cg.log_init, cg.log_final))
    assert cg.n_states == 150
    # 4 blocks of 50 frames: ends inside each block, on the boundaries,
    # and one block wholly masked
    cases["bench_shape"] = _case("forward_backward", rng.normal(size=(8, 200, 150)), loop,
                                 lengths=[200, 151, 150, 149, 101, 100, 51, 26])
    cg = jgraph.phone_loop_graph(4, 2).compile(jnp.float64)
    sparse = tuple(np.asarray(a) for a in (cg.log_trans, cg.log_init, cg.log_final))
    mask = np.ones((2, 32))
    mask[1, 20:] = 0
    cases["sparse_graph"] = _case("forward_backward", rng.normal(size=(2, 32, cg.n_states)),
                                  sparse, mask=mask)
    return cases


def _jax(case):
    """The JAX package's sharded run of a case on its 8-device CPU mesh."""
    from functools import partial

    import jax

    args = [jnp.asarray(case[k]) for k in ("llh", "log_trans", "log_init", "log_final", "mask")]
    if case["fn"] == "forward":
        return jsp.make_sharded_forward(jparallel.make_mesh(axis_name="seq"))(*args)
    if case["mesh"] is None:
        return jsp.make_sharded_forward_backward(jparallel.make_mesh(axis_name="seq"))(*args)
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "seq"))

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("data", "seq"), P(), P(), P(), P("data", "seq")),
             out_specs=(P("data", "seq"), P("data")), check_vma=False)
    def fn(llh, log_trans, log_init, log_final, mask):
        _, _, log_z, post = jsp.forward_backward_time_sharded(
            llh, log_trans, log_init, log_final, mask, "seq")
        return post, log_z

    return fn(*args)


def _unsharded(case):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return semiring_scan.forward_backward(*(t(case[k]) for k in (
        "llh", "log_trans", "log_init", "log_final", "mask")))


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    cases = _cases()
    out = tmp_path_factory.mktemp("sp")
    spawn(seq_parallel_cases, WORLD, out, out, cases)
    return cases, results(out, WORLD)


def _check_forward(got, want_la, want_lz, lengths):
    la, lz = got
    for i, ln in enumerate(lengths):
        close(la[i, :ln], np.asarray(want_la)[i, :ln], 1e-8)
    close(lz, want_lz, 1e-8)


def _check_forward_backward(got, want, lengths, beta=True):
    """``got``/``want``: (log α, log β, log Z, posteriors); log α and
    log β only where every state is reachable and can reach the end (on a sparse graph a state that
    cannot has log β "−∞", which the semiring products and the unsharded
    probability-space pass write differently, as in the JAX file)."""
    la, lb, lz, post = got
    close(lz, want[2], 1e-8)
    for i, ln in enumerate(lengths):
        if beta:
            close(la[i, :ln], np.asarray(want[0])[i, :ln], 1e-8)
            close(lb[i, :ln], np.asarray(want[1])[i, :ln], 1e-7, atol=1e-8)
        close(post[i, :ln], np.asarray(want[3])[i, :ln], 1e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["forward", "forward_backward", "bench_shape", "sparse_graph"])
def test_time_sharded_matches_jax_and_unsharded(sp_run, name):
    cases, ranks = sp_run
    case = cases[name]
    lengths = case["mask"].sum(1).astype(int)
    jax_out = _jax(case)
    fb = _unsharded(case)
    for found in ranks:      # every rank returns the whole arrays
        got = found[name]
        if name == "forward":
            _check_forward(got, jax_out[0], jax_out[1], lengths)
            _check_forward(got, fb.log_alpha, fb.log_z, lengths)
        else:
            dense = name == "forward_backward"
            _check_forward_backward(got, jax_out, lengths, beta=dense)
            _check_forward_backward(got, fb, lengths, beta=dense)
    for other in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(other[name], ranks[0][name]))


def test_data_and_time_sharded_2d_mesh(sp_run):
    """dp × sp: 2 data × 2 seq ranks, each its (rows, frames) block."""
    cases, ranks = sp_run
    case = cases["mesh_2x2"]
    jax_post, jax_lz = _jax(case)
    fb = _unsharded(case)
    seen = set()
    for found in ranks:
        got = found["mesh_2x2"]
        rows, cols = slice(*got["rows"]), slice(*got["cols"])
        seen.add((got["rows"], got["cols"]))
        close(got["log_z"], np.asarray(jax_lz)[rows], 1e-8)
        close(got["log_z"], fb.log_z[rows], 1e-8)
        close(got["posteriors"], np.asarray(jax_post)[rows, cols], 1e-6, atol=1e-9)
        close(got["posteriors"], fb.posteriors[rows, cols], 1e-6, atol=1e-9)
    assert len(seen) == WORLD


def test_one_rank_runs_no_exchange(tmp_path):
    """World size 1: the rank scans and the exclusive shift are the
    identity, no point-to-point exchange runs (the worker makes one
    raise), and the result is the unsharded one."""
    cases = {k: v for k, v in _cases().items() if k in ("forward", "forward_backward")}
    spawn(seq_parallel_cases, 1, tmp_path, tmp_path, cases)
    (found,) = results(tmp_path, 1)
    fb = _unsharded(cases["forward"])
    _check_forward(found["forward"], fb.log_alpha, fb.log_z,
                   cases["forward"]["mask"].sum(1).astype(int))
    case = cases["forward_backward"]
    _check_forward_backward(found["forward_backward"], _unsharded(case),
                            case["mask"].sum(1).astype(int))
    close(found["forward_backward"][2], _jax(case)[2], 1e-8)


def test_time_that_does_not_split_raises():
    from beer_tpu_torch.ops import seq_parallel

    class Mesh:    # a 1-D seq mesh of 4 ranks, as rank 0 sees it
        mesh_dim_names = ("seq",)
        mesh = torch.arange(4)

        def get_group(self, name):
            return None

        def size(self, dim=0):
            return 4

        def get_local_rank(self, name=None):
            return 0

        def get_coordinate(self):
            return [0]

    llh = torch.zeros(2, 30, 3)
    with pytest.raises(ValueError, match="do not split"):
        seq_parallel.make_sharded_forward_backward(Mesh())(
            llh, torch.zeros(3, 3), torch.zeros(3), torch.zeros(3), torch.ones(2, 30))
