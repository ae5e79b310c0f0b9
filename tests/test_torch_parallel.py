"""The port's data-parallel VB-EM (``beer_tpu_torch.parallel``) and the
data-parallel branches of ``hmm train``, on gloo ranks on the CPU.

The cases of ``tests/test_parallel.py`` run once on 4 gloo ranks
(``dist_util.parallel_cases``, a module fixture); the same numpy inputs
(from a seed) and the same initial models go through the JAX package's
own data-parallel functions on its 8-device CPU mesh and through the
port's single-process ``vb_step`` / ``elbo_and_stats``:

* float64 — a left-to-right HMM with full-covariance emissions (5 steps,
  16 utterances), the same on 13 utterances padded to 16, a
  full-covariance GMM over 800 frames (mask ``None``), the supervised
  recognizer on both ``transcription_graphs`` forms (3 steps): ELBO rtol
  1e-9, every parameter rtol 1e-8;
* float32 — a stochastic step of a phone loop (``datasize / n_valid`` =
  4) and an E-step of an ergodic HMM: ELBO rtol 1e-5, parameters /
  statistics rtol 1e-4 with atol 1e-6 / 1e-5 (``tests/test_parallel.py``'s);
* every rank's model bitwise equal to rank 0's.

``hmm train``'s data-parallel branches (full batch, ``--batch-size`` with
``--accumulate-batches``, ``--transcriptions``) run on 2 gloo ranks
through ``beer_tpu_torch.cli.main.main`` and are held against
``--single-device`` on the same files: each array of the final model
within 2e-4 of its largest entry and the ELBO within 1e-5 a frame
(float32 phone loop), rtol 1e-9 (float64 emissions).
"""

import contextlib
import io
import json
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beer_tpu
import beer_tpu_torch as bt
from beer_tpu import parallel as jparallel
from beer_tpu.models import graph as jgraph
from beer_tpu.models.hmm import HMM as JaxHMM
from beer_tpu.models.mixture import MixtureSet as JaxMixtureSet
from beer_tpu.models.phoneloop import PhoneLoop as JaxPhoneLoop
from beer_tpu_torch import parallel
from beer_tpu_torch.cli.main import main as cli
from beer_tpu_torch.convert import modelset_from_numpy
from beer_tpu_torch.utils import load_model, save_model
from dist_util import build_graphs, build_model, cli_runs, parallel_cases, results, spawn
from port_util import (close, hmm_to_numpy, mixture_to_numpy, modelset_to_numpy,
                       phone_loop_to_numpy)

WORLD = 4
RTOL_F64, RTOL_PARAMS_F64 = 1e-9, 1e-8


def _sequences(rng, b, t_len=30, d=2):
    """Three-segment utterances of random lengths in [t/2, t]."""
    means = np.array([[-3.0] * d, [0.0] * d, [3.0] * d])
    data, mask = np.zeros((b, t_len, d)), np.zeros((b, t_len))
    for i in range(b):
        ln = int(rng.integers(t_len // 2, t_len + 1))
        data[i, :ln] = means[np.clip((3 * np.arange(ln)) // ln, 0, 2)] \
            + 0.5 * rng.normal(size=(ln, d))
        mask[i, :ln] = 1
    return data, mask


def _full_cov_hmm(data, mask, key=5):
    d = data.shape[-1]
    flat = data.reshape(-1, d)[mask.reshape(-1) > 0]
    nset = beer_tpu.NormalSet.create(
        jnp.asarray(flat.mean(0)), jnp.asarray(np.cov(flat.T)), size=3, cov_type="full",
        noise_std=1.0, key=jax.random.PRNGKey(key))
    return JaxHMM.create(jgraph.left_to_right(3).compile(jnp.float64), nset)


def _jax_train(step, model, n, *args):
    elbos = []
    for _ in range(n):
        elbo, model = step(model, *args)
        elbos.append(float(elbo))
    return elbos, model


def _hmm_cases(rng, mesh):
    cases = {}
    data, mask = _sequences(rng, 16)
    jh = _full_cov_hmm(data, mask)
    elbos, jmodel = _jax_train(jparallel.make_vb_train_step(mesh), jh, 5, jnp.asarray(data),
                               jnp.asarray(mask))
    cases["full_batch"] = dict(model_type="HMM", model=hmm_to_numpy(jh), x=data, mask=mask,
                               step="train", steps=5, jax_elbos=elbos,
                               jax_model=hmm_to_numpy(jmodel))
    data, mask = _sequences(rng, 13)
    jh = _full_cov_hmm(data, mask)
    x_p, valid = jparallel.shard_batch(data, 8)
    mask_p = jparallel.shard_batch(mask, 8)[0] * valid[:, None]
    x_4, valid_4 = parallel.shard_batch(data, WORLD)
    np.testing.assert_array_equal(x_4, x_p)    # 13 → 16 rows on 4 ranks and on 8 devices
    np.testing.assert_array_equal(valid_4, valid)
    elbos, jmodel = _jax_train(jparallel.make_vb_train_step(mesh), jh, 1, jnp.asarray(x_p),
                               jnp.asarray(mask_p))
    cases["padded_batch"] = dict(model_type="HMM", model=hmm_to_numpy(jh), x=x_p, mask=mask_p,
                                 step="train", steps=1, jax_elbos=elbos,
                                 jax_model=hmm_to_numpy(jmodel), single=(data, mask))
    return cases


def _gmm_case(rng, mesh):
    """A full-covariance GMM over frames: JAX's psum of the statistics
    over 8 devices (``tests/test_parallel.py::test_gmm_dp``), then its
    update."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    frames = rng.normal(size=(800, 2)) + np.array([2.0, -1.0])
    nset = beer_tpu.NormalSet.create(
        jnp.asarray(frames.mean(0)), jnp.asarray(np.cov(frames.T)), size=4, cov_type="full",
        noise_std=1.0, key=jax.random.PRNGKey(0))
    gmm = beer_tpu.Mixture.create(nset)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("data")), out_specs=(P(), P()),
             check_vma=False)
    def dp_estep(model, x):
        stats = model.sufficient_statistics(x)
        llh, cache = model.infer(stats)
        return (jax.lax.psum(llh.sum(), "data"),
                jax.lax.psum(model.accumulate(stats, cache), "data"))

    llh, acc = dp_estep(gmm, jnp.asarray(frames))
    elbo = float(llh) - float(gmm.kl_div_posterior_prior())
    return dict(model_type="Mixture", model=mixture_to_numpy(gmm), x=frames, mask=None,
                step="train", steps=1, jax_elbos=[elbo],
                jax_model=mixture_to_numpy(gmm.vb_update(acc)))


def _supervised_cases(rng, mesh):
    n_phones, states, d = 3, 2, 2
    transcriptions = [[int(p) for p in rng.integers(n_phones, size=int(rng.integers(2, 5)))]
                      for _ in range(8)]
    base = rng.normal(size=(n_phones * states, d)) * 3.0
    seqs = []
    for phones in transcriptions:
        seqs.append(np.concatenate([
            base[ph * states + st] + 0.3 * rng.normal(size=(int(rng.integers(3, 6)), d))
            for ph in phones for st in range(states)]))
    t_max = max(map(len, seqs))
    data, mask = np.zeros((8, t_max, d)), np.zeros((8, t_max))
    for i, seq in enumerate(seqs):
        data[i, :len(seq)] = seq
        mask[i, :len(seq)] = 1
    flat = data.reshape(-1, d)[mask.reshape(-1) > 0]
    nset = beer_tpu.NormalSet.create(
        jnp.asarray(flat.mean(0)), jnp.asarray(np.cov(flat.T)), size=n_phones * states * 2,
        cov_type="diagonal", noise_std=1.0, key=jax.random.PRNGKey(1))
    emissions = JaxMixtureSet.create(nset, nmix=n_phones * states)
    cases = {}
    for shared in (True, False):
        graphs = jgraph.transcription_graphs(transcriptions, n_phones, states,
                                             dtype=jnp.float64, shared=shared)
        elbos, em = _jax_train(jparallel.make_supervised_vb_train_step(mesh), emissions, 3,
                               graphs, jnp.asarray(data), jnp.asarray(mask))
        cases["supervised_" + ("shared" if shared else "per_utterance")] = dict(
            model_type="MixtureSet", model=modelset_to_numpy(emissions), x=data, mask=mask,
            step="supervised", steps=3, transcriptions=transcriptions, n_phones=n_phones,
            states=states, shared=shared, jax_elbos=elbos, jax_model=modelset_to_numpy(em))
    return cases


def _float32_cases(rng):
    """``tests/test_parallel.py``'s minibatch and E-step cases, in float32."""
    f32 = jnp.float32
    b, t, d = 16, 20, 3
    data = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = rng.integers(t // 2, t + 1, size=b)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    nset = beer_tpu.NormalSet.create(jnp.zeros(d, f32), jnp.ones(d, f32), size=6,
                                     cov_type="diagonal", noise_std=0.5,
                                     key=jax.random.PRNGKey(0))
    loop = JaxPhoneLoop.create(3, 2, nset, dtype=f32)
    datasize = 64
    step = jparallel.make_vb_minibatch_step(jparallel.make_mesh(8))
    elbo, jloop = step(loop, jnp.asarray(data), jnp.asarray(mask), jnp.float32(datasize / b))
    cases = {"minibatch": dict(model_type="PhoneLoop", model=phone_loop_to_numpy(loop), x=data,
                               mask=mask, step="minibatch", datascale=datasize / b,
                               datasize=datasize, jax_elbos=[float(elbo)],
                               jax_model=phone_loop_to_numpy(jloop))}
    n, k = 64, 4
    data = rng.normal(size=(n, 8, d)).astype(np.float32)
    mask = np.ones((n, 8), np.float32)
    nset = beer_tpu.NormalSet.create(jnp.zeros(d, f32), jnp.ones(d, f32), size=k,
                                     cov_type="diagonal", noise_std=0.5,
                                     key=jax.random.PRNGKey(1))
    hmm = JaxHMM.create(jgraph.ergodic(k).compile(f32), nset)
    elbo, acc = jparallel.make_vb_estep(jparallel.make_mesh(8))(hmm, jnp.asarray(data),
                                                                 jnp.asarray(mask))
    cases["estep"] = dict(model_type="HMM", model=hmm_to_numpy(hmm), x=data, mask=mask,
                          step="estep", jax_elbos=[float(elbo)],
                          jax_acc=[np.asarray(a) for a in jax.tree.leaves(acc["modelset"])])
    return cases


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Every case through the JAX package's parallel functions, then once
    through the port's on 4 gloo ranks; (cases, per-rank results)."""
    rng = np.random.default_rng(42)
    mesh = jparallel.make_mesh()
    cases = {**_hmm_cases(rng, mesh), "gmm": _gmm_case(rng, mesh),
             **_supervised_cases(rng, mesh), **_float32_cases(rng)}
    out = tmp_path_factory.mktemp("dp")
    worker_cases = {name: {k: v for k, v in case.items() if not k.startswith("jax_")}
                    for name, case in cases.items()}
    spawn(parallel_cases, WORLD, out, out, worker_cases)
    return cases, results(out, WORLD)


def _arrays(tree, path=""):
    """{path: ndarray} of a ``to_numpy`` dict (other leaves dropped)."""
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items() for p, a in _arrays(v, f"{path}/{k}").items()}
    return {path: tree} if isinstance(tree, np.ndarray) else {}


def _close_models(got, want, rtol, atol):
    got, want = _arrays(got), _arrays(want)
    assert got.keys() == want.keys()
    for key in want:
        close(got[key], want[key], rtol, atol=atol)


def _single_process(case):
    """The port's single-process run of a case from the same start."""
    model = build_model(case)
    x, mask = case.get("single", (case["x"], case["mask"]))
    x = torch.from_numpy(x)
    mask = None if mask is None else torch.from_numpy(mask)
    if case["step"] == "estep":
        elbo, acc = bt.elbo_and_stats(model, x, mask=mask)
        return [float(elbo)], [a.numpy() for a in jax.tree.leaves(acc["modelset"])]
    if case["step"] == "supervised":
        model = bt.HMM.create(build_graphs(case), model)
    elbos = []
    for _ in range(case.get("steps", 1)):
        elbo, model = bt.vb_step(model, x, datasize=case.get("datasize"), mask=mask)
        elbos.append(float(elbo))
    if case["step"] == "supervised":
        model = model.modelset
    return elbos, model.to_numpy()


F64_CASES = ["full_batch", "padded_batch", "gmm", "supervised_shared", "supervised_per_utterance"]


@pytest.mark.parametrize("name", F64_CASES + ["minibatch", "estep"])
def test_data_parallel_matches_jax_and_single_process(dp_run, name):
    cases, ranks = dp_run
    case, got = cases[name], ranks[0][name]
    f64 = name in F64_CASES
    rtol_elbo = RTOL_F64 if f64 else 1e-5
    rtol, atol = (RTOL_PARAMS_F64, 1e-12) if f64 else (1e-4, 1e-6)
    single_elbos, single = _single_process(case)
    close(got["elbos"], case["jax_elbos"], rtol_elbo)
    close(got["elbos"], single_elbos, rtol_elbo)
    if name == "estep":
        assert len(got["acc"]) == len(case["jax_acc"]) == len(single)
        for a, j, s in zip(got["acc"], case["jax_acc"], single):
            close(a, j, 1e-4, atol=1e-5)
            close(a, s, 1e-4, atol=1e-5)
        return
    _close_models(got["model"], case["jax_model"], rtol, atol)
    _close_models(got["model"], single, rtol, atol)


def test_every_rank_holds_rank_zeros_model(dp_run):
    """The update runs on every rank from the same reduced statistics, so
    the models stay replicated bit for bit."""
    _, ranks = dp_run
    for other in ranks[1:]:
        for name, found in ranks[0].items():
            assert other[name]["elbos"] == found["elbos"], name
            if "model" in found:
                a, b = _arrays(other[name]["model"]), _arrays(found["model"])
                assert all(np.array_equal(a[k], b[k]) for k in b), name
            else:
                assert all(np.array_equal(x, y) for x, y in zip(other[name]["acc"], found["acc"]))


def test_module_surface_is_the_jax_packages():
    from beer_tpu.ops import seq_parallel as jax_seq_parallel
    from beer_tpu_torch.ops import seq_parallel

    assert sorted(parallel.__all__) == sorted(jparallel.__all__)
    for name in jparallel.__all__:
        assert callable(getattr(parallel, name))
    public = [n for n in vars(jax_seq_parallel) if not n.startswith("_")
              and callable(getattr(jax_seq_parallel, n))
              and getattr(jax_seq_parallel, n).__module__ == jax_seq_parallel.__name__]
    assert len(public) == 5
    for name in public:
        assert getattr(seq_parallel, name).__module__ == seq_parallel.__name__


def test_steps_refuse_a_batch_that_does_not_split_and_need_a_group():
    class Mesh:    # a 1-D mesh of 4 ranks, as rank 1 sees it
        mesh_dim_names = ("data",)

        def get_group(self, name):
            return None

        def size(self, dim=0):
            return 4

        def get_local_rank(self, name=None):
            return 1

    model = bt.NormalSet.create(torch.zeros(2), torch.ones(2), size=2)
    with pytest.raises(ValueError, match="does not split"):
        parallel.make_vb_estep(Mesh())(model, torch.zeros(6, 3, 2), torch.ones(6, 3))
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(device="cpu")


# ----------------------------------------------------------------------
# hmm train's data-parallel branches on 2 gloo ranks
# ----------------------------------------------------------------------
CLI_WORLD = 2
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """5 tone utterances through the port's ``dataset create``,
    ``features extract``, ``hmm mkphoneloop`` and ``hmm mkphones``
    (its emissions carried to float64), then each training on 2 gloo
    ranks (6 rows, one padded) and with ``--single-device``."""
    rng = np.random.default_rng(3)
    root = tmp_path_factory.mktemp("dp_cli")
    (root / "audio").mkdir()
    scp = []
    for i in range(5):
        sig = np.concatenate([
            np.sin(2 * np.pi * float(rng.uniform(80, 400)) * np.arange(4000) / 16000.0)
            for _ in range(3)]).astype(np.float32)
        np.save(root / "audio" / f"utt{i}.npy", sig)
        scp.append(f"utt{i} {root / 'audio' / f'utt{i}.npy'}")
    (root / "wav.scp").write_text("\n".join(scp))
    (root / "features.yml").write_text(
        "feature_type: fbank\nn_filters: 10\ndeltas: false\nsrate: 16000\n")
    (root / "hmm.yml").write_text(
        "n_units: 4\nstates_per_unit: 2\ncov_type: diagonal\nconcentration: 2.0\n")
    (root / "phones.yml").write_text(
        "states_per_phone: 2\nncomp_per_state: 1\ncov_type: diagonal\n")
    (root / "train.trans").write_text("\n".join(f"utt{i} a b c" for i in range(5)) + "\n")
    r = str(root)
    feats = r + "/feats.npz"
    for argv in (["dataset", "create", r + "/wav.scp", r + "/manifest.json"],
                 ["features", "extract", r + "/features.yml", r + "/manifest.json", feats],
                 ["hmm", "mkphoneloop", r + "/hmm.yml", feats, r + "/init.mdl"],
                 ["hmm", "mkphones", r + "/phones.yml", feats, r + "/train.trans",
                  r + "/em32.mdl"]):
        assert cli(argv + CPU) == 0, argv
    em = modelset_from_numpy(load_model(r + "/em32.mdl", "cpu").to_numpy(), device="cpu",
                                dtype=torch.float64)
    save_model(em, r + "/em.mdl")
    shutil.copy(r + "/em32.mdl.phones.json", r + "/em.mdl.phones.json")
    runs = {
        "full_batch": ["hmm", "train", r + "/init.mdl", feats, "{out}", "--epochs", "3",
                       "--nan-guard"],
        "accumulate": ["hmm", "train", r + "/init.mdl", feats, "{out}", "--epochs", "2",
                       "--batch-size", "3", "--accumulate-batches"],
        "transcriptions": ["hmm", "train", r + "/em.mdl", feats, "{out}", "--epochs", "3",
                           "--transcriptions", r + "/train.trans"],
    }
    dp = {k: [a.format(out=f"{r}/dp_{k}") for a in v] + CPU for k, v in runs.items()}
    spawn(cli_runs, CLI_WORLD, root, root, dp)
    single = {}
    for k, v in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli([a.format(out=f"{r}/single_{k}") for a in v] + CPU
                       + ["--single-device"]) == 0
        single[k] = buf.getvalue()
    return root, results(root, CLI_WORLD), single


def _printed_elbos(printed):
    return [float(v) for v in re.findall(r"epoch \d+: elbo/frame = (\S+)", printed)]


@pytest.mark.parametrize("run", ["full_batch", "accumulate", "transcriptions"])
def test_hmm_train_data_parallel_equals_single_device(cli_run, run):
    root, printed, single_printed = cli_run
    dp_dir, single_dir = root / f"dp_{run}", root / f"single_{run}"
    lead = {"full_batch": "data-parallel", "accumulate": "minibatch data-parallel",
            "transcriptions": "supervised data-parallel"}[run]
    assert printed[0][run].startswith(f"{lead} over {CLI_WORLD} devices\n")
    assert printed[1][run] == ""     # rank 0 alone prints and writes
    epochs = sorted(p.name for p in single_dir.glob("epoch*.mdl"))
    assert sorted(p.name for p in dp_dir.glob("epoch*.mdl")) == epochs
    dp_elbos, single_elbos = _printed_elbos(printed[0][run]), _printed_elbos(single_printed[run])
    assert len(dp_elbos) == len(single_elbos) == len(epochs)
    assert np.all(np.diff(dp_elbos) > 0)
    dp_model = load_model(dp_dir / "final.mdl", "cpu").state_dict()
    single = load_model(single_dir / "final.mdl", "cpu").state_dict()
    assert dp_model.keys() == single.keys()
    if run == "transcriptions":    # float64 emissions
        assert (dp_dir / "final.mdl.phones.json").exists()
        for name in single:
            close(dp_model[name], single[name], RTOL_F64, atol=1e-12)
        close(dp_elbos, single_elbos, 0.0, atol=1e-6)    # printed to 6 decimals
        return
    for name in single:
        err = float((dp_model[name] - single[name]).abs().max()
                    / single[name].abs().max().clamp_min(1e-30))
        assert err <= 2e-4, (name, err)
    logged, single_logged = ([json.loads(line)["elbo_per_frame"] for line in
                              (d / "log" / "metrics.jsonl").read_text().splitlines()]
                             for d in (dp_dir, single_dir))
    assert len(logged) == len(single_logged) == len(epochs)
    assert max(abs(a - b) for a, b in zip(logged, single_logged)) <= 1e-5
