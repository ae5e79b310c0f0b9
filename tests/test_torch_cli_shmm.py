"""The port's ``shmm train`` verb.

On a phone loop trained by the JAX CLI on ``tests/test_cli.py``'s
miniature data (4 tone utterances, fbank with 10 filters, 4 units × 2
states, 5 epochs) and carried across: the assertions of
``tests/test_cli.py``'s single-language and H-SHMM cases, two runs equal
bit for bit, and one outer iteration equal bit for bit to the same
composition of ``vb_step``, ``accumulate_unit_stats``,
``make_gsm_train_scan`` and ``apply_to_phoneloop`` with the verb's
generators (CPU, seeded 0 for the models, ``train_key(1)`` for the
steps' noise), so the verb adds no arithmetic of its own.  Random
streams cannot match the JAX verb's (ROADMAP §C.2), so the port's verb
is held to the JAX verb's run on the same loop by its outputs' form and
by bands on the GSM and loop ELBOs.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from beer_tpu.cli.main import main as jax_cli
from beer_tpu.utils import load_model as jax_load_model
from beer_tpu_torch.cli.main import main as cli
from beer_tpu_torch.convert import phone_loop_from_numpy
from beer_tpu_torch.utils import load_model, save_model
from port_util import phone_loop_to_numpy

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("shmm_port")
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
    (root / "hmm.yml").write_text(
        "n_units: 4\nstates_per_unit: 2\ncov_type: diagonal\nconcentration: 2.0\n")
    r = str(root)
    for argv in (
        ["dataset", "create", r + "/wav.scp", r + "/manifest.json"],
        ["features", "extract", r + "/features.yml", r + "/manifest.json", r + "/feats.npz"],
        ["hmm", "mkphoneloop", r + "/hmm.yml", r + "/feats.npz", r + "/init.mdl"],
        ["hmm", "train", r + "/init.mdl", r + "/feats.npz", r + "/exp", "--epochs", "5",
         "--single-device"],
    ):
        with contextlib.redirect_stdout(io.StringIO()):
            assert jax_cli(argv) == 0, argv
    loop = phone_loop_from_numpy(phone_loop_to_numpy(jax_load_model(root / "exp" / "final.mdl")),
                                 device="cpu")
    save_model(loop, root / "loop.mdl")
    return root


def _shmm(root, out, extra):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert cli(["shmm", "train", str(root / "loop.mdl"), str(root / "feats.npz"), str(out)]
                   + extra + CPU) == 0
    return printed.getvalue()


def _gsm_elbos(printed):
    return [float(v) for v in re.findall(r"outer \d+: gsm elbo = (\S+)", printed)]


def _equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


SINGLE = ["--embed-dim", "2", "--outer-iters", "2", "--inner-iters", "50"]


def test_shmm_single_language(workdir, tmp_path):
    """``tests/test_cli.py``'s single-language case: the loop and the GSM
    are written, the GSM has one embedding a unit."""
    printed = _shmm(workdir, tmp_path / "shmm", SINGLE)
    assert (tmp_path / "shmm" / "final.mdl").exists()
    gsm = load_model(tmp_path / "shmm" / "gsm.mdl", device="cpu")
    assert type(gsm).__name__ == "GSM"
    assert gsm.e_mean.shape[0] == 4
    elbos = _gsm_elbos(printed)
    assert len(elbos) == 2 and np.isfinite(elbos).all()
    assert printed.splitlines()[-1].startswith("wrote ")


def test_shmm_matches_the_jax_verb(workdir, tmp_path):
    """``shmm train --device cpu`` (its inner loop through
    ``make_gsm_train_scan``) against the JAX verb on the loop both start
    from: the same lines and files, a GSM of the same type and shapes,
    each outer iteration's GSM ELBO within 10 % of the JAX verb's (their
    initial draws and noise differ), and the written-back loops' ELBO per
    frame within 2 % of each other."""
    import beer_tpu_torch as bt
    from beer_tpu_torch import io as bio
    from port_util import gsm_to_port

    args = ["--embed-dim", "2", "--outer-iters", "2", "--inner-iters", "100"]
    printed = _shmm(workdir, tmp_path / "port", args)
    jax_printed = io.StringIO()
    with contextlib.redirect_stdout(jax_printed):
        assert jax_cli(["shmm", "train", str(workdir / "exp" / "final.mdl"),
                        str(workdir / "feats.npz"), str(tmp_path / "jax")] + args) == 0
    jax_printed = jax_printed.getvalue()
    form = lambda text: re.sub(r"-?\d+\.\d+", "#", text.replace("port", "jax"))  # noqa: E731
    assert form(printed) == form(jax_printed)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    gsm = load_model(tmp_path / "port" / "gsm.mdl", device="cpu")
    want = gsm_to_port(jax_load_model(tmp_path / "jax" / "gsm.mdl"))
    assert type(gsm) is type(want)
    assert [(n, p.shape) for n, p in gsm.named_parameters()] == \
        [(n, p.shape) for n, p in want.named_parameters()]
    elbos, jax_elbos = _gsm_elbos(printed), _gsm_elbos(jax_printed)
    assert len(elbos) == len(jax_elbos) == 2
    assert np.allclose(elbos, jax_elbos, rtol=0.1)
    _, data, mask = bio.load_padded(workdir / "feats.npz")
    x, m = torch.from_numpy(data), torch.from_numpy(mask)
    per_frame = [float(bt.elbo_and_stats(loop, x, mask=m)[0]) / float(mask.sum())
                 for loop in (load_model(tmp_path / "port" / "final.mdl", device="cpu"),
                              phone_loop_from_numpy(phone_loop_to_numpy(
                                  jax_load_model(tmp_path / "jax" / "final.mdl")), device="cpu"))]
    assert np.isfinite(per_frame).all()
    assert abs(per_frame[0] - per_frame[1]) <= 0.02 * abs(per_frame[1])


def test_shmm_runs_are_bitwise_equal(workdir, tmp_path):
    printed = [_shmm(workdir, tmp_path / f"run{i}", SINGLE) for i in (0, 1)]
    assert printed[0].replace("run0", "run1") == printed[1]
    for name in ("final.mdl", "gsm.mdl"):
        _equal(load_model(tmp_path / "run0" / name, device="cpu"),
               load_model(tmp_path / "run1" / name, device="cpu"))


def test_shmm_multilingual(workdir, tmp_path):
    """``tests/test_cli.py``'s H-SHMM case: ``--extra-lang`` makes a
    HierarchicalGSM over both languages' units, writes each language's
    loop, and the transition write-back happened."""
    root = workdir
    exp = tmp_path / "hshmm"
    printed = _shmm(root, exp, [
        "--extra-lang", f"L2:{root / 'loop.mdl'}:{root / 'feats.npz'}",
        "--embed-dim", "2", "--lang-dim", "2", "--learn-transitions",
        "--outer-iters", "2", "--inner-iters", "40", "--loop-epochs", "1"])
    assert (exp / "final.mdl").exists() and (exp / "final_L2.mdl").exists()
    gsm = load_model(exp / "gsm.mdl", device="cpu")
    assert type(gsm).__name__ == "HierarchicalGSM"
    assert gsm.n_units == 8 and gsm.n_langs == 2
    assert gsm.learn_transitions
    assert load_model(exp / "final.mdl", device="cpu").log_exit is not None
    assert load_model(exp / "final_L2.mdl", device="cpu").log_exit is not None
    assert np.isfinite(_gsm_elbos(printed)).all()


def test_shmm_refuses_different_topologies(workdir, tmp_path):
    root = workdir
    (tmp_path / "hmm.yml").write_text("n_units: 3\nstates_per_unit: 2\n")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(["hmm", "mkphoneloop", str(tmp_path / "hmm.yml"), str(root / "feats.npz"),
                    str(tmp_path / "other.mdl")] + CPU) == 0
    with pytest.raises(ValueError, match="same loop topology"):
        _shmm(root, tmp_path / "bad", ["--extra-lang", f"L2:{tmp_path / 'other.mdl'}:"
                                       f"{root / 'feats.npz'}", "--outer-iters", "1"])


@pytest.mark.parametrize("variant", ["single", "trunk", "hierarchical_transitions"])
def test_shmm_outer_iteration_is_the_composition(workdir, tmp_path, variant):
    """One outer iteration of the verb equals, bit for bit, the port's
    functions composed by hand with the same generators and optimizer."""
    import beer_tpu_torch as bt
    from beer_tpu_torch import io as bio
    from beer_tpu_torch.cli.subcommands.shmm_train import cat_stats
    from beer_tpu_torch.models.gsm import make_gsm_train_scan, train_key

    root = workdir
    extra = ["--embed-dim", "3", "--outer-iters", "1", "--inner-iters", "7", "--loop-epochs", "2",
             "--writeback-samples", "16", "--lrate", "0.05"]
    n_langs = 1
    if variant == "trunk":
        extra += ["--trunk", "mlp:5:tanh"]
    if variant == "hierarchical_transitions":
        extra += ["--extra-lang", f"B:{root / 'loop.mdl'}:{root / 'feats.npz'}",
                  "--learn-transitions", "--lang-dim", "2"]
        n_langs = 2
    printed = _shmm(root, tmp_path / "verb", extra)

    _, data, mask = bio.load_padded(root / "feats.npz")
    x, m = torch.from_numpy(data), torch.from_numpy(mask)
    loops = [load_model(root / "loop.mdl", device="cpu") for _ in range(n_langs)]
    transitions = variant == "hierarchical_transitions"
    init = torch.Generator().manual_seed(0)
    if n_langs > 1:
        gsm = bt.HierarchicalGSM.create(8, 3, x.shape[-1], lang_dim=2, n_langs=2,
                                        unit_lang=[0] * 4 + [1] * 4, states_per_unit=2,
                                        learn_transitions=True, generator=init, device="cpu")
    else:
        gsm = bt.GSM.create(4, 3, x.shape[-1], states_per_unit=2,
                            trunk="mlp:5:tanh" if variant == "trunk" else None,
                            generator=init, device="cpu")
    optimizer = torch.optim.Adam(gsm.parameters(), lr=0.05)
    noise = train_key(1, "cpu")
    for loop in loops:
        for _ in range(2):
            bt.vb_step(loop, x, mask=m)
    per_lang = [bt.accumulate_unit_stats(loop, x, m, transitions=transitions) for loop in loops]
    stats = cat_stats([st for st, _ in per_lang])
    counts = torch.cat([ct for _, ct in per_lang])
    elbo = make_gsm_train_scan(optimizer)(gsm, stats, counts, generator=noise, nsteps=7)
    for i, loop in enumerate(loops):
        sub = bt.slice_gsm(gsm, i, 4) if n_langs > 1 else gsm
        bt.apply_to_phoneloop(sub, loop, generator=noise, nsamples=16)

    assert _gsm_elbos(printed) == [float(f"{elbo.item():.2f}")]
    _equal(load_model(tmp_path / "verb" / "gsm.mdl", device="cpu"), gsm)
    _equal(load_model(tmp_path / "verb" / "final.mdl", device="cpu"), loops[0])
    if n_langs > 1:
        _equal(load_model(tmp_path / "verb" / "final_B.mdl", device="cpu"), loops[1])
