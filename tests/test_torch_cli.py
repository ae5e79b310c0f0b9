"""The port's CLI against beer_tpu's: the AUD recipe's five verbs.

``dataset create`` → ``features extract`` → ``hmm mkphoneloop`` → ``hmm
train`` (resume, minibatches, streaming, ``--nan-guard``) → ``hmm
decode``, driven through ``beer_tpu_torch.cli.main.main`` with
``--device cpu``, beside ``beer_tpu.cli.main.main`` on the same files.
The JAX pipeline runs once per module on ``tests/test_cli.py``'s
miniature data (4 tone utterances of 0.75 s, fbank with 10 filters, 4
units × 2 states), with the JAX package's CPU settings of
``tests/conftest.py``.  For every verb of the CLI (the supervised, map-reduce
and ``shmm`` verbs have their own files) this file also holds the device
rule, the imports and the verbs' arguments against ``beer_tpu.cli``.

Tolerances (float32 on both sides):
* features: log-mel within 1e-3 absolute wherever the mel energy is
  above 1e-6 (10⁴ × the energy floor; FFT rounding there is below 1e-4
  relative); both archives hold the same utterances, keys and shapes;
* the initial model: every array within rtol 1e-6 (the same numpy
  k-means and jitter, then the same float32 arithmetic);
* training from the same initial model: the ELBO per frame of every
  epoch within 1e-4 (BASELINE's bar), resume included; full batch and
  ``--accumulate-batches`` (and automatic streaming) to rtol 2e-4, atol
  1e-5, as ``tests/test_cli.py`` holds the JAX verbs;
* decode: the transcriptions equal, per frame and collapsed.
"""

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from beer_tpu.cli.main import main as jax_cli
from beer_tpu.utils import load_model as jax_load_model
from beer_tpu_torch.cli.main import main as cli
from beer_tpu_torch.convert import phone_loop_from_numpy
from beer_tpu_torch.utils import load_model, save_model
from port_util import phone_loop_to_numpy

ELBO_PER_FRAME = 1e-4
CPU = ["--device", "cpu"]


def _elbos(run_dir):
    lines = (run_dir / "log" / "metrics.jsonl").read_text().splitlines()
    return {r["step"]: r["elbo_per_frame"] for r in map(json.loads, lines)}


def _carry(jax_mdl, out):
    """A JAX ``.mdl`` phone loop as the port's ``.mdl`` (on the CPU)."""
    loop = phone_loop_from_numpy(phone_loop_to_numpy(jax_load_model(jax_mdl)), device="cpu")
    save_model(loop, out)
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """``tests/test_cli.py``'s data through the JAX CLI: manifest,
    features, the initial model (with and without the hyper-prior), 5
    epochs in two runs (the second resumes), 2 minibatch epochs, and the
    decodes per frame and collapsed."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("aud_jax")
    wav_dir = root / "audio"
    wav_dir.mkdir()
    scp_lines = []
    for i in range(4):
        sig = np.concatenate([
            np.sin(2 * np.pi * float(rng.uniform(80, 400)) * np.arange(4000) / 16000.0)
            for _ in range(3)
        ]).astype(np.float32)
        path = wav_dir / f"utt{i}.npy"
        np.save(path, sig)
        scp_lines.append(f"utt{i} {path}")
    (root / "wav.scp").write_text("\n".join(scp_lines))
    (root / "features.yml").write_text(
        "feature_type: fbank\nn_filters: 10\ndeltas: false\nsrate: 16000\n")
    (root / "recipe_features.yml").write_text(
        "feature_type: fbank\nsrate: 16000\nframe_length_ms: 25.0\nframe_shift_ms: 10.0\n"
        "n_fft: 512\nn_filters: 26\ndeltas: true\nmean_norm: true\n")
    (root / "hmm.yml").write_text(
        "n_units: 4\nstates_per_unit: 2\ncov_type: diagonal\nconcentration: 2.0\n")
    (root / "hmm_hp.yml").write_text(
        "n_units: 3\nstates_per_unit: 2\ncov_type: diagonal\nhyperprior: true\n")
    r = str(root)
    feats = r + "/feats.npz"
    for argv in (
        ["dataset", "create", r + "/wav.scp", r + "/manifest.json"],
        ["features", "extract", r + "/features.yml", r + "/manifest.json", feats],
        ["features", "extract", r + "/recipe_features.yml", r + "/manifest.json",
         r + "/recipe_feats.npz"],
        ["hmm", "mkphoneloop", r + "/hmm.yml", feats, r + "/init.mdl"],
        ["hmm", "mkphoneloop", r + "/hmm_hp.yml", feats, r + "/init_hp.mdl"],
        ["hmm", "train", r + "/init.mdl", feats, r + "/exp", "--epochs", "3", "--single-device"],
        ["hmm", "train", r + "/init.mdl", feats, r + "/exp", "--epochs", "5", "--single-device"],
        ["hmm", "train", r + "/init_hp.mdl", feats, r + "/exp_hp", "--epochs", "2",
         "--single-device"],
        ["hmm", "train", r + "/init.mdl", feats, r + "/exp_mb", "--epochs", "2",
         "--batch-size", "3", "--lrate", "0.5", "--single-device"],
        ["hmm", "decode", r + "/exp/final.mdl", feats, r + "/trans_frames.txt", "--per-frame"],
        ["hmm", "decode", r + "/exp/final.mdl", feats, r + "/trans.txt"],
    ):
        assert jax_cli(argv) == 0, argv
    return root


@pytest.mark.parametrize("source", ["scp", "directory"])
def test_dataset_create_matches_jax(jax_run, tmp_path, source):
    src = jax_run / ("wav.scp" if source == "scp" else "audio")
    want, got = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax_cli(["dataset", "create", str(src), str(want)]) == 0
    assert cli(["dataset", "create", str(src), str(got)]) == 0
    assert json.loads(got.read_text()) == json.loads(want.read_text())
    assert len(json.loads(got.read_text())["utterances"]) == 4


@pytest.mark.parametrize("conf,archive", [("features.yml", "feats.npz"),
                                          ("recipe_features.yml", "recipe_feats.npz")])
def test_features_extract_matches_jax(jax_run, tmp_path, conf, archive):
    out = tmp_path / "feats.npz"
    assert cli(["features", "extract", str(jax_run / conf), str(jax_run / "manifest.json"),
                str(out)] + CPU) == 0
    got, want = np.load(out), np.load(jax_run / archive)
    assert got.files == want.files
    for key in want.files:
        g, w = got[key], want[key]
        assert g.shape == w.shape and g.dtype == np.float32
        assert (1 + (12000 - 400) // 160, 10 if conf == "features.yml" else 78) == g.shape
        if conf == "features.yml":   # raw log-mel: compare above 1e-6 of energy
            above = np.exp(w) > 1e-6
            assert above.mean() > 0.9
            np.testing.assert_allclose(g[above], w[above], rtol=0, atol=1e-3)
        else:                        # deltas and mean-norm of the same log-mel
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)


def test_features_extract_cmvn_and_bar(jax_run, tmp_path):
    """``--cmvn global`` normalises the corpus; a ``.bar`` output holds
    the ``.npz`` output's arrays and is read by the JAX package."""
    from beer_tpu import io as jax_io

    man, conf = str(jax_run / "manifest.json"), str(jax_run / "features.yml")
    assert cli(["features", "extract", conf, man, str(tmp_path / "c.npz"), "--cmvn", "global"]
               + CPU) == 0
    feats = np.load(tmp_path / "c.npz")
    flat = np.concatenate([feats[k] for k in feats.files])
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(flat.std(0), 1.0, atol=1e-3)
    assert cli(["features", "extract", conf, man, str(tmp_path / "f.bar")] + CPU) == 0
    assert cli(["features", "extract", conf, man, str(tmp_path / "f.npz")] + CPU) == 0
    npz, bar = np.load(tmp_path / "f.npz"), jax_io.Archive(tmp_path / "f.bar")
    assert bar.keys == npz.files
    for i, key in enumerate(bar.keys):
        np.testing.assert_array_equal(bar[i], npz[key])


@pytest.mark.parametrize("conf,jax_init", [("hmm.yml", "init.mdl"), ("hmm_hp.yml", "init_hp.mdl")])
def test_mkphoneloop_matches_jax(jax_run, tmp_path, conf, jax_init):
    out = tmp_path / "init.mdl"
    assert cli(["hmm", "mkphoneloop", str(jax_run / conf), str(jax_run / "feats.npz"),
                str(out)] + CPU) == 0
    loop = load_model(out, device="cpu")
    jloop = jax_load_model(jax_run / jax_init)
    assert type(loop.unit_prior).__name__ == type(jloop.unit_prior).__name__
    got, want = loop.to_numpy(), phone_loop_to_numpy(jloop)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == np.float32, key
            np.testing.assert_allclose(got[key], value, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            assert got[key] == value, key
    assert loop.log_exit is None


@pytest.mark.parametrize("variant", ["resume", "hyperprior", "minibatch"])
def test_train_matches_jax(jax_run, tmp_path, variant):
    """From the JAX initial model carried across, the port's epochs give
    the JAX CLI's ELBO per frame within 1e-4: 3 epochs then 2 more on
    resume; the hyper-prior loop; stochastic minibatches (``--batch-size
    3 --lrate 0.5``, the same shuffles from seed 0)."""
    feats = str(jax_run / "feats.npz")
    exp = tmp_path / "exp"
    if variant == "resume":
        init = _carry(jax_run / "init.mdl", tmp_path / "init.mdl")
        runs, want = (["--epochs", "3"], ["--epochs", "5"]), _elbos(jax_run / "exp")
    elif variant == "hyperprior":
        init = _carry(jax_run / "init_hp.mdl", tmp_path / "init.mdl")
        runs, want = (["--epochs", "2"],), _elbos(jax_run / "exp_hp")
    else:
        init = _carry(jax_run / "init.mdl", tmp_path / "init.mdl")
        runs = (["--epochs", "2", "--batch-size", "3", "--lrate", "0.5"],)
        want = _elbos(jax_run / "exp_mb")
    for extra in runs:
        assert cli(["hmm", "train", str(init), feats, str(exp)] + extra + CPU) == 0
    got = _elbos(exp)
    assert sorted(got) == sorted(want)
    gaps = [abs(got[e] - want[e]) for e in want]
    assert max(gaps) <= ELBO_PER_FRAME, (got, want)
    if variant == "resume":
        assert all(np.diff([got[e] for e in sorted(got)]) >= -1e-6)
        jfinal = phone_loop_to_numpy(jax_load_model(jax_run / "exp" / "final.mdl"))
        final = load_model(exp / "final.mdl", device="cpu").to_numpy()
        np.testing.assert_allclose(final["modelset_posterior"], jfinal["modelset_posterior"],
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("streamed", [
    ["--batch-size", "2", "--buckets", "2", "--accumulate-batches"],
    ["--max-padded-gb", "1e-6"],
])
def test_streamed_training_is_full_batch(jax_run, tmp_path, streamed):
    """``--accumulate-batches`` (and the automatic switch above
    ``--max-padded-gb``) is full-batch VB through ``.bar`` minibatches."""
    init, feats = str(jax_run / "init.mdl"), str(tmp_path / "feats.npz")
    (tmp_path / "feats.npz").write_bytes((jax_run / "feats.npz").read_bytes())
    init = str(_carry(init, tmp_path / "init.mdl"))
    assert cli(["hmm", "train", init, feats, str(tmp_path / "full"), "--epochs", "3"] + CPU) == 0
    assert cli(["hmm", "train", init, feats, str(tmp_path / "acc"), "--epochs", "3"]
               + streamed + CPU) == 0
    assert (tmp_path / "feats.npz.bar").exists()
    full = load_model(tmp_path / "full" / "final.mdl", device="cpu")
    acc = load_model(tmp_path / "acc" / "final.mdl", device="cpu")
    for (name, a), (_, b) in zip(full.state_dict().items(), acc.state_dict().items()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=1e-5, err_msg=name)
    e_full, e_acc = _elbos(tmp_path / "full"), _elbos(tmp_path / "acc")
    assert max(abs(e_full[e] - e_acc[e]) for e in e_full) <= ELBO_PER_FRAME


@pytest.mark.parametrize("per_frame", [True, False])
def test_decode_matches_jax(jax_run, tmp_path, per_frame):
    model = _carry(jax_run / "exp" / "final.mdl", tmp_path / "final.mdl")
    out = tmp_path / "trans.txt"
    flag = ["--per-frame"] if per_frame else []
    assert cli(["hmm", "decode", str(model), str(jax_run / "feats.npz"), str(out)]
               + flag + CPU) == 0
    want = jax_run / ("trans_frames.txt" if per_frame else "trans.txt")
    assert out.read_text() == want.read_text()
    lines = out.read_text().splitlines()
    assert len(lines) == 4 and all(line.split()[1].startswith("au") for line in lines)
    if per_frame:
        feats = np.load(jax_run / "feats.npz")
        assert all(len(line.split()) - 1 == feats[line.split()[0]].shape[0] for line in lines)


@pytest.mark.parametrize("extra", [[], ["--batch-size", "4"]])
def test_nan_guard_names_the_step(jax_run, tmp_path, extra):
    feats = dict(np.load(jax_run / "feats.npz"))
    first = sorted(feats)[0]
    feats[first] = feats[first].copy()
    feats[first][0, 0] = np.nan
    bad = tmp_path / "bad.npz"
    np.savez(bad, **feats)
    init = _carry(jax_run / "init.mdl", tmp_path / "init.mdl")
    with pytest.raises(FloatingPointError, match=r"vb_step: non-finite values in outputs at "
                                                 r"\['\[0\]', '\[1\]\.modelset"):
        cli(["hmm", "train", str(init), str(bad), str(tmp_path / "guard"), "--epochs", "1",
             "--nan-guard"] + extra + CPU)
    assert not (tmp_path / "guard" / "epoch0001.mdl").exists()


VERBS = {
    "features": ["features", "extract", "{r}/features.yml", "{r}/manifest.json", "{out}.npz"],
    "mkphoneloop": ["hmm", "mkphoneloop", "{r}/hmm.yml", "{r}/feats.npz", "{out}.mdl"],
    "train": ["hmm", "train", "{r}/init.mdl", "{r}/feats.npz", "{out}"],
    "decode": ["hmm", "decode", "{r}/exp/final.mdl", "{r}/feats.npz", "{out}.txt"],
    "mkphones": ["hmm", "mkphones", "{r}/phones.yml", "{r}/feats.npz", "{r}/train.trans",
                 "{out}.mdl"],
    "train_transcriptions": ["hmm", "train", "{r}/em.mdl", "{r}/feats.npz", "{out}",
                             "--transcriptions", "{r}/train.trans"],
    "decode_phone_lm": ["hmm", "decode", "{r}/em.mdl", "{r}/feats.npz", "{out}.txt",
                        "--phone-lm", "--lm-transcriptions", "{r}/train.trans"],
    "align": ["hmm", "align", "{r}/em.mdl", "{r}/feats.npz", "{r}/train.trans", "{out}.txt"],
    "accumulate": ["hmm", "accumulate", "{r}/init.mdl", "{r}/feats.npz", "{out}.acc"],
    "update": ["hmm", "update", "{r}/init.mdl", "{out}.mdl", "{r}/shard1.acc"],
    "shmm": ["shmm", "train", "{r}/exp/final.mdl", "{r}/feats.npz", "{out}"],
}


@pytest.mark.parametrize("verb", list(VERBS))
def test_computing_verbs_need_a_card_or_cpu(jax_run, tmp_path, monkeypatch, verb):
    """No ``--device``: each verb that computes builds on the CUDA card,
    and raises where there is none (no fallback to the CPU), before it
    writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.format(r=jax_run, out=tmp_path / "out") for a in VERBS[verb]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(argv)
    assert not list(tmp_path.iterdir())


def test_train_starts_one_rank_per_card(jax_run, tmp_path, monkeypatch):
    """Several visible cards, no process group and no ``--single-device``:
    ``hmm train`` starts one data-parallel rank per card (the ranks
    themselves run in ``tests/test_torch_parallel.py`` on gloo)."""
    from beer_tpu_torch.cli.subcommands import hmm_train

    started = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(hmm_train, "_spawn", lambda args, n: started.append((args.epochs, n)))
    argv = ["hmm", "train", str(jax_run / "init.mdl"), str(jax_run / "feats.npz"),
            str(tmp_path / "exp"), "--device", "cuda", "--epochs", "2"]
    assert cli(argv) == 0
    assert started == [(2, 3)]
    assert not (tmp_path / "exp").exists()


@pytest.mark.parametrize("form", ["path", "opened"])
def test_pad_archive_matches_jax(jax_run, form):
    """``hmm_train.pad_archive`` of a path or of an opened ``.npz`` equals
    the JAX verb's."""
    from beer_tpu.cli.subcommands.hmm_train import pad_archive as jax_pad_archive
    from beer_tpu_torch.cli.subcommands.hmm_train import pad_archive

    path = jax_run / "feats.npz"
    arg = path if form == "path" else np.load(path)
    want = jax_pad_archive(arg)
    got = pad_archive(arg if form == "path" else np.load(path))
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_groups_are_the_jax_packages():
    """The port's CLI has every group and verb of ``beer_tpu.cli``, in its
    order, and each verb takes the JAX verb's arguments."""
    import argparse
    import importlib

    jax_main = importlib.import_module("beer_tpu.cli.main")
    port_main = importlib.import_module("beer_tpu_torch.cli.main")
    assert port_main.GROUPS == jax_main.GROUPS
    assert list(port_main.GROUPS) == list(jax_main.GROUPS)
    for group, cmds in jax_main.GROUPS.items():
        for cmd in cmds:
            parsers = []
            for package in ("beer_tpu", "beer_tpu_torch"):
                parser = argparse.ArgumentParser()
                importlib.import_module(f"{package}.cli.subcommands.{group}_{cmd}").setup(parser)
                parsers.append({(a.dest, tuple(a.option_strings), a.nargs, repr(a.default))
                                for a in parser._actions})
            assert parsers[1] == parsers[0], (group, cmd)


def test_cli_module_loads_no_jax():
    """``python -m beer_tpu_torch.cli`` runs; the CLI with every verb, io,
    features and utils import neither JAX nor beer_tpu."""
    help_out = subprocess.run([sys.executable, "-m", "beer_tpu_torch.cli", "hmm", "--help"],
                              capture_output=True, text=True, timeout=120)
    assert help_out.returncode == 0, help_out.stderr
    assert re.search(r"mkphones.*mkphoneloop.*align.*train.*decode.*accumulate.*update",
                     help_out.stdout.replace("\n", " "))
    code = ("import sys, importlib, beer_tpu_torch.io, beer_tpu_torch.features, "
            "beer_tpu_torch.utils; m = importlib.import_module('beer_tpu_torch.cli.main'); "
            "[importlib.import_module(f'beer_tpu_torch.cli.subcommands.{g}_{c}') "
            "for g, cs in m.GROUPS.items() for c in cs]; "
            "bad = [n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'beer_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
