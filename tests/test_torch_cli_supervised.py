"""The port's supervised-recipe verbs against beer_tpu's.

``hmm mkphones`` → ``hmm train --transcriptions`` (resumed) → ``hmm
decode --phone-lm [--lm-transcriptions]`` and ``hmm align``, driven
through ``beer_tpu_torch.cli.main.main`` with ``--device cpu`` beside
``beer_tpu.cli.main.main`` on the same files.  The JAX pipeline runs
once per module on ``tests/test_cli.py``'s miniature data (4 tone
utterances of 0.75 s, fbank with 10 filters, the transcription ``a b
c`` for each, 2 states a phone).

Precision.  Under the tests' x64 mode the JAX verb makes the mixture
weights float64, so its ELLH, forward and statistics run in float64;
the port is compared on the same arithmetic by carrying the JAX
emissions across at float64 (the verbs cast the features to the
emissions' dtype).  In float32 both packages' scaled forward loses
utterance 0 of this data after one update: every reachable state's
ELLH falls more than ~100 nats below the frame's maximum, its α̂
underflows, and the ELBO stops rising (ROADMAP §C.1).

Tolerances:
* mkphones (the port's own, float32): every array within rtol 1e-6 of
  the JAX verb's (the same numpy draws), an equal ``.phones.json``;
* training: the ELBO per frame of every epoch within 1e-4 (BASELINE's
  bar), resume included; the final emissions within rtol 2e-4, atol
  1e-5;
* decode and align: equal transcriptions, frame by frame.
"""

import contextlib
import io
import json
import re
import shutil

import numpy as np
import pytest
import torch

from beer_tpu.cli.main import main as jax_cli
from beer_tpu.utils import load_model as jax_load_model
from beer_tpu_torch.cli.main import main as cli
from beer_tpu_torch.convert import mixture_set_from_numpy
from beer_tpu_torch.utils import load_model, save_model
from port_util import modelset_to_numpy

ELBO_PER_FRAME = 1e-4
CPU = ["--device", "cpu"]


def _run(main, argv):
    """``main(argv)`` with its printed lines returned."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0, argv
    return out.getvalue()


def _elbos(printed):
    return {int(e): float(v) for e, v in re.findall(r"epoch (\d+): elbo/frame = (\S+)", printed)}


def _carry(jax_mdl, out, dtype=torch.float64):
    """JAX ``hmm mkphones`` / ``hmm train --transcriptions`` emissions as
    the port's ``.mdl``, with the ``.phones.json`` beside it."""
    ms = mixture_set_from_numpy(modelset_to_numpy(jax_load_model(jax_mdl)), device="cpu",
                                dtype=dtype)
    save_model(ms, out)
    shutil.copy(str(jax_mdl) + ".phones.json", str(out) + ".phones.json")
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The supervised pipeline through the JAX CLI: features, mkphones
    (diagonal, full and isotropic covariance), 3 then 5 epochs of supervised
    training (resumed), the phone-loop decodes (uniform and bigram LM,
    per frame and collapsed) and the alignments of the trained and of
    the initial emissions."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("sup_jax")
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
    (root / "train.trans").write_text("\n".join(f"utt{i} a b c" for i in range(4)) + "\n")
    # an LM file with a phone outside the inventory, which the LM drops
    (root / "lm.trans").write_text("u0 a b c\nu1 a c b a\nu2 b x c\n")
    (root / "phones.yml").write_text(
        "states_per_phone: 2\nncomp_per_state: 1\ncov_type: diagonal\n")
    (root / "phones_full.yml").write_text(
        "states_per_phone: 2\nncomp_per_state: 2\ncov_type: full\n")
    (root / "phones_iso.yml").write_text(
        "states_per_phone: 2\nncomp_per_state: 1\ncov_type: isotropic\n")
    r = str(root)
    feats, trans = r + "/feats.npz", r + "/train.trans"
    printed = {}
    for name, argv in (
        ("manifest", ["dataset", "create", r + "/wav.scp", r + "/manifest.json"]),
        ("features", ["features", "extract", r + "/features.yml", r + "/manifest.json", feats]),
        ("mkphones", ["hmm", "mkphones", r + "/phones.yml", feats, trans, r + "/em.mdl"]),
        ("mkphones_full", ["hmm", "mkphones", r + "/phones_full.yml", feats, trans,
                           r + "/em_full.mdl"]),
        ("mkphones_iso", ["hmm", "mkphones", r + "/phones_iso.yml", feats, trans,
                          r + "/em_iso.mdl"]),
        ("train_3", ["hmm", "train", r + "/em.mdl", feats, r + "/exp", "--epochs", "3",
                     "--transcriptions", trans, "--single-device"]),
        ("train_5", ["hmm", "train", r + "/em.mdl", feats, r + "/exp", "--epochs", "5",
                     "--transcriptions", trans, "--single-device"]),
        ("decode_uniform_frames", ["hmm", "decode", r + "/exp/final.mdl", feats,
                                   r + "/hyp_uniform_frames.txt", "--phone-lm", "--per-frame"]),
        ("decode_uniform", ["hmm", "decode", r + "/exp/final.mdl", feats,
                            r + "/hyp_uniform.txt", "--phone-lm"]),
        ("decode_bigram_frames", ["hmm", "decode", r + "/exp/final.mdl", feats,
                                  r + "/hyp_bigram_frames.txt", "--phone-lm", "--per-frame",
                                  "--lm-transcriptions", r + "/lm.trans"]),
        ("decode_bigram", ["hmm", "decode", r + "/exp/final.mdl", feats, r + "/hyp_bigram.txt",
                           "--phone-lm", "--lm-transcriptions", r + "/lm.trans"]),
        ("align_trained", ["hmm", "align", r + "/exp/final.mdl", feats, trans,
                           r + "/ali_trained.txt"]),
        ("align_initial", ["hmm", "align", r + "/em.mdl", feats, trans, r + "/ali_initial.txt"]),
    ):
        printed[name] = _run(jax_cli, argv)
    (root / "printed.json").write_text(json.dumps(printed))
    return root


def _mkphones_matches_jax(jax_run, tmp_path, conf, jax_mdl, printed_key):
    out = tmp_path / "em.mdl"
    printed = _run(cli, ["hmm", "mkphones", str(jax_run / conf), str(jax_run / "feats.npz"),
                         str(jax_run / "train.trans"), str(out)] + CPU)
    assert printed == json.loads((jax_run / "printed.json").read_text())[printed_key].replace(
        str(jax_run / jax_mdl), str(out))
    assert (tmp_path / "em.mdl.phones.json").read_bytes() == \
        (jax_run / (jax_mdl + ".phones.json")).read_bytes()
    got = load_model(out, device="cpu").to_numpy()
    want = modelset_to_numpy(jax_load_model(jax_run / jax_mdl))
    assert got["nmix"] == want["nmix"] == 6
    assert got["ncomp_per_mix"] == want["ncomp_per_mix"]
    assert got["modelset"]["cov_type"] == want["modelset"]["cov_type"]
    for key in ("weights_prior", "weights_posterior"):
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    for key in ("prior", "posterior"):
        assert got["modelset"][key].dtype == np.float32
        np.testing.assert_allclose(got["modelset"][key], want["modelset"][key], rtol=1e-6,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("conf,jax_mdl", [("phones.yml", "em.mdl"),
                                          ("phones_full.yml", "em_full.mdl")])
def test_mkphones_matches_jax(jax_run, tmp_path, conf, jax_mdl):
    _mkphones_matches_jax(jax_run, tmp_path, conf, jax_mdl,
                          "mkphones" if conf == "phones.yml" else "mkphones_full")


def test_mkphones_refuses_covariance_types_not_ported(jax_run, tmp_path):
    """The isotropic type, once refused, is ported: ``hmm mkphones`` with
    ``cov_type: isotropic`` makes the JAX verb's model (the same test as
    the diagonal and full ones above)."""
    _mkphones_matches_jax(jax_run, tmp_path, "phones_iso.yml", "em_iso.mdl", "mkphones_iso")


def test_train_transcriptions_matches_jax(jax_run, tmp_path):
    """From the JAX emissions carried across, 3 epochs then 2 more on
    resume give the JAX verb's ELBO per frame within 1e-4; each
    checkpoint and ``final.mdl`` hold the emissions, beside a copy of the
    ``.phones.json``."""
    em = _carry(jax_run / "em.mdl", tmp_path / "em.mdl")
    feats, trans = str(jax_run / "feats.npz"), str(jax_run / "train.trans")
    exp = tmp_path / "exp"
    got = _elbos(_run(cli, ["hmm", "train", str(em), feats, str(exp), "--epochs", "3",
                            "--transcriptions", trans] + CPU))
    resumed = _run(cli, ["hmm", "train", str(em), feats, str(exp), "--epochs", "5",
                         "--transcriptions", trans] + CPU)
    assert "resuming from" in resumed and "(epoch 3)" in resumed
    got.update(_elbos(resumed))
    printed = json.loads((jax_run / "printed.json").read_text())
    want = {**_elbos(printed["train_3"]), **_elbos(printed["train_5"])}
    assert sorted(got) == sorted(want) == [1, 2, 3, 4, 5]
    assert max(abs(got[e] - want[e]) for e in want) <= ELBO_PER_FRAME, (got, want)
    assert all(np.diff([got[e] for e in sorted(got)]) >= -1e-6)
    assert (exp / "final.mdl.phones.json").read_bytes() == \
        (jax_run / "em.mdl.phones.json").read_bytes()
    for name in ("epoch0005.mdl", "final.mdl"):
        assert type(load_model(exp / name, device="cpu")).__name__ == "MixtureSet"
    final = load_model(exp / "final.mdl", device="cpu").to_numpy()
    jfinal = modelset_to_numpy(jax_load_model(jax_run / "exp" / "final.mdl"))
    for a, b in ((final["weights_posterior"], jfinal["weights_posterior"]),
                 (final["modelset"]["posterior"], jfinal["modelset"]["posterior"])):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)


def test_train_transcriptions_is_one_vb_step_an_epoch(jax_run, tmp_path):
    """In float32 the verb is an HMM on shared transcription graphs and
    ``vb_step`` per epoch, bit for bit, and ``--batch-size`` does not
    take supervised training off the full batch."""
    import beer_tpu_torch as bt
    from beer_tpu_torch import io as bio

    em = _carry(jax_run / "em.mdl", tmp_path / "em.mdl", dtype=torch.float32)
    feats, trans = str(jax_run / "feats.npz"), str(jax_run / "train.trans")
    printed = _run(cli, ["hmm", "train", str(em), feats, str(tmp_path / "exp"), "--epochs", "2",
                         "--transcriptions", trans, "--batch-size", "2"] + CPU)
    assert "streaming" not in printed
    keys, data, mask = bio.load_padded(feats)
    x, m = torch.from_numpy(data), torch.from_numpy(mask)
    phones = json.loads((jax_run / "em.mdl.phones.json").read_text())["phones"]
    seqs = [[phones.index(p) for p in "abc"] for _ in keys]
    hmm = bt.HMM.create(bt.transcription_graphs(seqs, 3, 2, device="cpu"),
                        load_model(em, device="cpu"))
    assert hmm.route() == "llh"
    want = {}
    for epoch in (1, 2):
        elbo, hmm = bt.vb_step(hmm, x, mask=m)
        want[epoch] = f"{elbo.item() / float(mask.sum()):.6f}"
    assert {e: f"{v:.6f}" for e, v in _elbos(printed).items()} == want
    got = load_model(tmp_path / "exp" / "final.mdl", device="cpu")
    for (name, a), (_, b) in zip(got.state_dict().items(), hmm.modelset.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("lm", ["uniform", "bigram"])
@pytest.mark.parametrize("per_frame", [True, False])
def test_decode_phone_lm_matches_jax(jax_run, tmp_path, lm, per_frame):
    model = _carry(jax_run / "exp" / "final.mdl", tmp_path / "final.mdl")
    tag = f"{lm}_frames" if per_frame else lm
    out = tmp_path / "hyp.txt"
    argv = ["hmm", "decode", str(model), str(jax_run / "feats.npz"), str(out), "--phone-lm"]
    argv += ["--per-frame"] if per_frame else []
    argv += ["--lm-transcriptions", str(jax_run / "lm.trans")] if lm == "bigram" else []
    assert cli(argv + CPU) == 0
    assert out.read_text() == (jax_run / f"hyp_{tag}.txt").read_text()
    lines = out.read_text().splitlines()
    assert len(lines) == 4 and all(set(line.split()[1:]) <= set("abc") for line in lines)
    if per_frame:
        feats = np.load(jax_run / "feats.npz")
        assert all(len(line.split()) - 1 == feats[line.split()[0]].shape[0] for line in lines)


@pytest.mark.parametrize("emissions", ["trained", "initial"])
def test_align_matches_jax(jax_run, tmp_path, emissions):
    src = jax_run / ("exp/final.mdl" if emissions == "trained" else "em.mdl")
    model = _carry(src, tmp_path / "em.mdl")
    out = tmp_path / "ali.txt"
    assert cli(["hmm", "align", str(model), str(jax_run / "feats.npz"),
                str(jax_run / "train.trans"), str(out)] + CPU) == 0
    assert out.read_text() == (jax_run / f"ali_{emissions}.txt").read_text()
    feats = np.load(jax_run / "feats.npz")
    for line in out.read_text().splitlines():
        key, *labels = line.split()
        assert len(labels) == feats[key].shape[0]
        # a forced alignment visits the transcription's phones in order
        assert [p for i, p in enumerate(labels) if i == 0 or labels[i - 1] != p] == list("abc")
