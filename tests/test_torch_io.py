"""The port's ``io`` and ``utils`` against beer_tpu's.

``io``: the cases of ``tests/test_io.py`` (the native reader, built by
``g++`` into ``beer_tpu_torch/_build/``, against the pure-Python one),
then the format across packages: the same utterances written by either
package give the same bytes, each package reads the other's archives,
and the two ``BatchLoader``s serve the same batches.

``utils``: the cases of ``tests/test_utils.py`` for the port's own
checkpoint format (tensors as a state dict read with ``weights_only``,
beside a pickled skeleton; a ``None`` field stays ``None``), the YAML
loader (against the JAX package's, with and without PyYAML), the finite
guards and the metrics logger (the spans: ``test_torch_tracing.py``).
All exact: no arithmetic is compared here.
"""

import io as pyio
import json
import pickle
import sys

import numpy as np
import pytest
import torch

import beer_tpu_torch as bt
from beer_tpu import io as jax_io
from beer_tpu import utils as jax_utils
from beer_tpu_torch import io as bio
from beer_tpu_torch import utils
from beer_tpu_torch.utils import checkpoint


@pytest.fixture
def archive_path(rng, tmp_path):
    utts = {
        f"utt{i:03d}": rng.normal(size=(int(rng.integers(5, 40)), 13)).astype(np.float32)
        for i in range(17)
    }
    path = tmp_path / "feats.bar"
    bio.write_archive(path, utts)
    return path, utts


# ----------------------------------------------------------------------
# io: the cases of tests/test_io.py
# ----------------------------------------------------------------------
def test_native_compiles():
    assert bio._load_native() is not None, "native archive lib failed to build"
    lib = bio._build_native()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "beer_tpu_torch"


def test_roundtrip_native_and_python(archive_path):
    path, utts = archive_path
    native = bio.Archive(path, prefer_native=True)
    pure = bio.Archive(path, prefer_native=False)
    assert native.native and not pure.native
    assert native.keys == list(utts.keys()) == pure.keys
    for i, key in enumerate(native.keys):
        np.testing.assert_array_equal(native[i], utts[key])
        np.testing.assert_array_equal(pure[i], utts[key])


def test_padded_batch_matches_fallback(archive_path):
    path, _ = archive_path
    native = bio.Archive(path, prefer_native=True)
    pure = bio.Archive(path, prefer_native=False)
    idx = [3, 0, 16, 7]
    out_n, mask_n = native.padded_batch(idx)
    out_p, mask_p = pure.padded_batch(idx)
    np.testing.assert_array_equal(out_n, out_p)
    np.testing.assert_array_equal(mask_n, mask_p)
    np.testing.assert_array_equal(mask_n.sum(1), native.lengths[idx])
    assert (out_n[mask_n == 0.0] == 0).all()


def test_batch_loader_covers_epoch(archive_path):
    path, utts = archive_path
    loader = bio.BatchLoader(bio.Archive(path), batch_size=5, seed=1)
    total = 0
    for data, mask in loader:
        assert data.shape[0] <= 5 and data.shape[2] == 13
        total += int((mask.sum(1) > 0).sum())
    assert total == len(utts)


def test_convert_npz(tmp_path, rng):
    npz = tmp_path / "f.npz"
    utts = {"a": rng.normal(size=(7, 4)).astype(np.float32),
            "b": rng.normal(size=(3, 4)).astype(np.float32)}
    np.savez(npz, **utts)
    bar = tmp_path / "f.bar"
    bio.convert_npz(npz, bar)
    archive = bio.Archive(bar)
    np.testing.assert_array_equal(archive[0], utts["a"])
    np.testing.assert_array_equal(archive[1], utts["b"])


def test_batch_loader_buckets(archive_path):
    """Length bucketing: epoch coverage, per-bucket shapes, exact content."""
    path, utts = archive_path
    loader = bio.BatchLoader(bio.Archive(path), batch_size=4, seed=1, buckets=3,
                             pad_multiple=8)
    assert len(loader.bucket_indices) >= 2
    seen, shapes = [], set()
    for data, mask in loader:
        shapes.add(data.shape[1])
        for b in range(data.shape[0]):
            n = int(mask[b].sum())
            for k, v in utts.items():
                if v.shape[0] == n and np.allclose(data[b, :n], v):
                    seen.append(k)
                    break
    assert sorted(seen) == sorted(utts.keys())
    assert len(shapes) >= 2
    lengths = np.array([v.shape[0] for v in utts.values()])
    assert max(shapes) <= -(-int(lengths.max()) // 8) * 8
    assert min(shapes) < int(lengths.max())


def test_archive_geometry(archive_path, tmp_path):
    path, utts = archive_path
    lengths = [v.shape[0] for v in utts.values()]
    want = (len(utts), max(lengths), 13, sum(lengths))
    assert bio.archive_geometry(path) == want
    npz = tmp_path / "feats.npz"
    np.savez(npz, **utts)
    assert bio.archive_geometry(npz) == want


# ----------------------------------------------------------------------
# io: the format across packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("how", ["write_archive", "convert_npz"])
def test_bar_bytes_equal_the_jax_writer(archive_path, tmp_path, how):
    _, utts = archive_path
    ours, theirs = tmp_path / "port.bar", tmp_path / "jax.bar"
    if how == "write_archive":
        bio.write_archive(ours, utts)
        jax_io.write_archive(theirs, utts)
    else:
        np.savez(tmp_path / "u.npz", **utts)
        bio.convert_npz(tmp_path / "u.npz", ours)
        jax_io.convert_npz(tmp_path / "u.npz", theirs)
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("native", [True, False])
def test_each_package_reads_the_others_archives(archive_path, tmp_path, native):
    path, utts = archive_path
    jax_path = tmp_path / "jax.bar"
    jax_io.write_archive(jax_path, utts)
    for reader in (bio.Archive(jax_path, prefer_native=native),
                   jax_io.Archive(path, prefer_native=native)):
        assert reader.native == native and reader.keys == list(utts)
        for i, key in enumerate(reader.keys):
            np.testing.assert_array_equal(reader[i], utts[key])
    out_p, mask_p = bio.Archive(jax_path, prefer_native=native).padded_batch([5, 1, 9])
    out_j, mask_j = jax_io.Archive(path, prefer_native=native).padded_batch([5, 1, 9])
    np.testing.assert_array_equal(out_p, out_j)
    np.testing.assert_array_equal(mask_p, mask_j)
    assert bio.archive_geometry(jax_path) == jax_io.archive_geometry(path)
    keys_p, data_p, m_p = bio.load_padded(jax_path)
    keys_j, data_j, m_j = jax_io.load_padded(path)
    assert keys_p == keys_j
    np.testing.assert_array_equal(data_p, data_j)
    np.testing.assert_array_equal(m_p, m_j)


def test_batch_loader_serves_the_jax_loaders_batches(archive_path):
    """Same seed, same buckets: the same batches in the same order."""
    path, _ = archive_path
    ours = bio.BatchLoader(bio.Archive(path), batch_size=4, seed=3, buckets=3, pad_multiple=8)
    theirs = jax_io.BatchLoader(jax_io.Archive(path), batch_size=4, seed=3, buckets=3,
                                pad_multiple=8)
    for _ in range(2):   # two epochs: the generator's state carries across
        got, want = list(ours), list(theirs)
        assert len(got) == len(want)
        for (d1, m1), (d2, m2) in zip(got, want):
            np.testing.assert_array_equal(d1, d2)
            np.testing.assert_array_equal(m1, m2)


# ----------------------------------------------------------------------
# utils: the cases of tests/test_utils.py
# ----------------------------------------------------------------------
def _gmm(rng):
    data = rng.normal(size=(100, 2))
    nset = bt.NormalSet.create(torch.as_tensor(data.mean(0)), torch.as_tensor(np.cov(data.T)),
                               size=3, cov_type="full")
    return bt.Mixture.create(nset), torch.as_tensor(data)


def _same_tensors(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for key in sa:
        assert sa[key].dtype == sb[key].dtype, key
        torch.testing.assert_close(sb[key], sa[key], rtol=0, atol=0)


def test_checkpoint_roundtrip(rng, tmp_path):
    gmm, data = _gmm(rng)
    _, gmm = bt.vb_step(gmm, data)
    path = tmp_path / "model.mdl"
    utils.save_model(gmm, path)
    loaded = utils.load_model(path, device="cpu")
    assert type(loaded) is type(gmm)
    _same_tensors(gmm, loaded)
    # the loaded model trains on, like the original
    e1, _ = bt.vb_step(loaded, data)
    e2, _ = bt.vb_step(gmm, data)
    assert np.isfinite(float(e1)) and float(e1) == float(e2)


def test_latest_checkpoint(tmp_path):
    assert utils.latest_checkpoint(tmp_path) is None
    assert utils.latest_checkpoint(tmp_path / "missing") is None
    for i in (1, 3, 2):
        (tmp_path / f"epoch{i:04d}.mdl").write_bytes(b"x")
    assert utils.latest_checkpoint(tmp_path).name == "epoch0003.mdl"


@pytest.mark.parametrize("pyyaml", [True, False])
def test_yaml_matches_jax(tmp_path, monkeypatch, pyyaml):
    cfg = tmp_path / "c.yml"
    cfg.write_text("n_units: 20  # units\ncov_type: diagonal\ndeltas: true\nlr: 0.5\n"
                   "name: 'x'\n")
    if not pyyaml:
        monkeypatch.setitem(sys.modules, "yaml", None)   # import yaml raises
    out = utils.load_yaml(cfg)
    assert out == {"n_units": 20, "cov_type": "diagonal", "deltas": True, "lr": 0.5,
                   "name": "x"}
    assert out == jax_utils.load_yaml(cfg)


def test_nan_guard_catches():
    guarded = utils.nan_guard(torch.log, "log")
    with pytest.raises(FloatingPointError, match=r"log: non-finite values in outputs at \[''\]"):
        guarded(torch.tensor([-1.0]))
    torch.testing.assert_close(guarded(torch.tensor([1.0])), torch.tensor([0.0]))


def test_metrics_logger(tmp_path, capsys):
    logger = utils.MetricsLogger(tmp_path, stdout=True)
    logger.log(0, elbo_per_frame=-4.2, frames_per_sec=1e6)
    logger.log(1, elbo_per_frame=-4.0, frames_per_sec=1.1e6)
    logger.close()
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[1])
    assert rec["step"] == 1 and rec["elbo_per_frame"] == -4.0
    assert "[step 1] elbo_per_frame=-4 frames_per_sec=1.1e+06" in capsys.readouterr().out


def _families(rng):
    """One of each of the port's model families, on the CPU."""
    nset = bt.NormalSet.create(torch.zeros(3), torch.ones(3), size=6, noise_std=0.5)
    loop = bt.PhoneLoop.create(2, 3, nset)
    hp = bt.PhoneLoop.create(
        2, 3, bt.NormalSet.create(torch.zeros(3), torch.ones(3), size=6, noise_std=0.5),
        unit_prior=bt.SBCategoricalHyperPrior.create(2, 2.0, 1.0, device="cpu"))
    hp.log_exit = torch.log(torch.tensor([0.2, 0.3]))
    hmm = bt.HMM.create(bt.ergodic(4),
                        bt.NormalSet.create(torch.zeros(3), torch.ones(3), size=4),
                        learn_transitions=True)
    gmm, _ = _gmm(rng)
    vae = bt.VAE.create(4, 2, bt.NormalSet.create(torch.zeros(2), torch.ones(2), size=1),
                        hidden=(8,))
    hgsm = bt.HierarchicalGSM.create(3, 2, 4, n_langs=2, unit_lang=[0, 0, 1], device="cpu")
    return {"phoneloop": loop, "phoneloop_hyperprior": hp, "hmm": hmm, "gmm": gmm,
            "vae": vae, "hgsm": hgsm}


@pytest.mark.parametrize("name", ["phoneloop", "phoneloop_hyperprior", "hmm", "gmm", "vae",
                                  "hgsm"])
def test_checkpoint_roundtrip_all_families(rng, tmp_path, name):
    """Every family reloads with its tensors (buffers and nnet
    parameters), its statics and its None fields."""
    model = _families(rng)[name]
    path = tmp_path / f"{name}.mdl"
    utils.save_model(model, path)
    loaded = utils.load_model(path, device="cpu")
    assert type(loaded) is type(model)
    _same_tensors(model, loaded)
    assert [type(m) for m in loaded.modules()] == [type(m) for m in model.modules()]
    for (n1, p1), (n2, p2) in zip(model.named_parameters(), loaded.named_parameters()):
        assert n1 == n2 and isinstance(p2, torch.nn.Parameter) and p2.requires_grad
    if name.startswith("phoneloop"):
        assert (loaded.log_exit is None) == (name == "phoneloop")
        assert loaded.n_units == 2 and loaded.self_loop == model.self_loop
        x = torch.as_tensor(rng.normal(size=(2, 9, 3)), dtype=torch.float32)
        e1, _ = bt.vb_step(model, x)
        e2, _ = bt.vb_step(loaded, x)
        assert float(e1) == float(e2)


def test_checkpoint_format(tmp_path):
    """The tensors load with ``weights_only=True``; the skeleton holds no
    tensor data; a tensor shared by two fields stays one tensor; with no
    card and no device, loading raises."""
    nset = bt.NormalSet.create(torch.zeros(3), torch.ones(3), size=6)
    loop = bt.PhoneLoop.create(2, 3, nset)
    loop.shared = loop.base_log_trans
    utils.save_model(loop, tmp_path / "m.mdl")
    payload = pickle.loads((tmp_path / "m.mdl").read_bytes())
    assert payload["format"] == checkpoint.FORMAT
    tensors = torch.load(pyio.BytesIO(payload["tensors"]), weights_only=True)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in tensors.values())
    assert b"_rebuild_tensor" not in payload["skeleton"]   # no tensor pickled inline
    assert sum(t.numel() for t in tensors.values()) == sum(
        t.numel() for t in loop.state_dict().values())      # the shared one stored once
    loaded = utils.load_model(tmp_path / "m.mdl", device="cpu")
    assert loaded.shared is loaded.base_log_trans
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            utils.load_model(tmp_path / "m.mdl")
    (tmp_path / "bad.mdl").write_bytes(pickle.dumps({"skeleton": b"", "arrays": b""}))
    with pytest.raises(ValueError, match="not a beer_tpu_torch checkpoint"):
        utils.load_model(tmp_path / "bad.mdl", device="cpu")


def test_guard_finite_outputs():
    """Passes finite trees, raises with the paths of non-finite fields
    (tuples, dicts and a module's buffers)."""
    check = utils.guard_finite_outputs("dp_step")
    check({"a": torch.ones(3), "b": (torch.zeros(2), torch.tensor(1))})
    bad = {"a": torch.ones(3), "b": (torch.tensor([1.0, np.nan]), torch.tensor(1))}
    with pytest.raises(FloatingPointError, match=r"dp_step: .*\['b'\]\[0\]"):
        check(bad)
    nset = bt.NormalSet.create(torch.zeros(2), torch.ones(2), size=2)
    nset.means_precisions.posterior[0, 0] = float("inf")
    with pytest.raises(FloatingPointError, match=r"\[1\]\.means_precisions\.posterior"):
        check((torch.tensor(0.0), nset))
    with pytest.raises(FloatingPointError, match=r"non-finite values at model\.means_prec"):
        utils.assert_finite(nset, "model")
