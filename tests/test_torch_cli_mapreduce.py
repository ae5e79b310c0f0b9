"""The port's file-based map-reduce VB-EM: ``hmm accumulate`` + ``hmm update``.

Every case of ``tests/test_cli_mapreduce.py`` through the port's CLI
(``--device cpu``): the shards' summed statistics and one conjugate
update are one full-batch ``vb_step``; the shard ELBOs reduce to the
full ELBO; duplicate shards and incomplete sets are refused; a shard of
one batch is not padded.  Then the port's pair against the JAX pair on
the JAX ``init.mdl`` carried across (``port_util.phone_loop_to_numpy``).
The SGE case stays with the JAX package: ``recipes/lib/parallel_vbem.sh``
calls ``beer_tpu.cli``.

Data: ``test_cli_mapreduce.py``'s 5 utterances of 20–60 random 6-dim
frames, a phone loop of 3 units × 2 states from ``hmm mkphoneloop``.
Tolerances: against the port's own ``vb_step`` rtol 2e-5, atol 2e-5 (the
JAX test's: the same statistics summed in another order); against the
JAX verbs rtol 2e-4, atol 1e-5 and the ELBO per frame within 1e-4.
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from beer_tpu.cli.main import main as jax_cli
from beer_tpu.utils import load_model as jax_load_model
from beer_tpu_torch import vbi
from beer_tpu_torch.cli.main import main as cli
from beer_tpu_torch.convert import phone_loop_from_numpy
from beer_tpu_torch.utils import load_model, save_model
from port_util import phone_loop_to_numpy

CPU = ["--device", "cpu"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0, argv
    return out.getvalue()


def _per_frame(printed):
    return float(re.search(r"elbo/frame = (\S+)", printed).group(1))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The corpus, the JAX initial model, the JAX map-reduce over 2
    shards, and the JAX model carried across as the port's ``init.mdl``."""
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("mapreduce_port")
    feats = {f"utt{i}": rng.normal(size=(int(rng.integers(20, 60)), 6)).astype(np.float32)
             for i in range(5)}
    np.savez(root / "feats.npz", **feats)
    (root / "hmm.yml").write_text(
        "n_units: 3\nstates_per_unit: 2\ncov_type: diagonal\nconcentration: 2.0\n")
    r = str(root)
    printed = {"mkphoneloop": _run(jax_cli, ["hmm", "mkphoneloop", r + "/hmm.yml",
                                             r + "/feats.npz", r + "/jax_init.mdl"])}
    for i in (1, 2):
        printed[f"acc{i}"] = _run(jax_cli, ["hmm", "accumulate", r + "/jax_init.mdl",
                                            r + "/feats.npz", f"{r}/jax_shard{i}.acc",
                                            "--shard", f"{i}/2"])
    printed["update"] = _run(jax_cli, ["hmm", "update", r + "/jax_init.mdl", r + "/jax_mr.mdl",
                                       r + "/jax_shard1.acc", r + "/jax_shard2.acc"])
    save_model(phone_loop_from_numpy(phone_loop_to_numpy(jax_load_model(root / "jax_init.mdl")),
                                     device="cpu"), root / "init.mdl")
    for i in (1, 2):
        printed[f"port_acc{i}"] = _run(cli, ["hmm", "accumulate", r + "/init.mdl",
                                             r + "/feats.npz", f"{r}/shard{i}.acc",
                                             "--shard", f"{i}/2"] + CPU)
    (root / "printed.json").write_text(json.dumps(printed))
    return root


def _full_batch(root):
    from beer_tpu_torch import io as bio

    _, data, mask = bio.load_padded(root / "feats.npz")
    return torch.from_numpy(data), torch.from_numpy(mask)


def _assert_models_close(a, b, rtol, atol):
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_accumulate_update_matches_vb_step(workdir, tmp_path, n_shards):
    root = workdir
    if n_shards == 2:
        accs = [root / "shard1.acc", root / "shard2.acc"]
    else:
        accs = [tmp_path / f"shard{i}.acc" for i in range(1, n_shards + 1)]
        for i, acc in enumerate(accs, 1):
            assert cli(["hmm", "accumulate", str(root / "init.mdl"), str(root / "feats.npz"),
                        str(acc), "--shard", f"{i}/{n_shards}"] + CPU) == 0
    out = tmp_path / "mr.mdl"
    assert cli(["hmm", "update", str(root / "init.mdl"), str(out)]
               + [str(a) for a in accs] + CPU) == 0
    x, m = _full_batch(root)
    _, full = vbi.vb_step(load_model(root / "init.mdl", device="cpu"), x, mask=m)
    _assert_models_close(load_model(out, device="cpu"), full, rtol=2e-5, atol=2e-5)


def test_shard_elbos_reduce_to_full_elbo(workdir):
    """Sum of shard ELBOs (KL kept once) == full-batch ELBO; the shards'
    frames sum to the corpus's."""
    root = workdir
    payloads = [load_model(root / f"shard{i}.acc", device="cpu") for i in (1, 2)]
    model = load_model(root / "init.mdl", device="cpu")
    kl = model.kl_div_posterior_prior().item()
    reduced = sum(p["elbo"] for p in payloads) + kl
    x, m = _full_batch(root)
    with torch.no_grad():
        full_elbo, _ = vbi.elbo_and_stats(model, x, mask=m)
    frames = float(m.sum())
    assert abs(reduced - full_elbo.item()) / frames < 1e-4
    assert sum(p["frames"] for p in payloads) == frames
    assert [(p["shard"], p["n_shards"], p["n_utts"]) for p in payloads] == [(1, 2, 3), (2, 2, 2)]


def test_update_rejects_duplicate_shards(workdir, tmp_path):
    root = workdir
    with pytest.raises(SystemExit, match="duplicate shard 1/2"):
        cli(["hmm", "update", str(root / "init.mdl"), str(tmp_path / "dup.mdl"),
             str(root / "shard1.acc"), str(root / "shard1.acc")] + CPU)
    assert not (tmp_path / "dup.mdl").exists()


def test_update_rejects_incomplete_shard_set(workdir, tmp_path):
    """A set that is not a complete i/N set is refused (stale .acc
    protection) unless --allow-partial is given, which warns."""
    root = workdir
    argv = ["hmm", "update", str(root / "init.mdl"), str(tmp_path / "part.mdl"),
            str(root / "shard1.acc")] + CPU
    with pytest.raises(SystemExit, match="not a complete"):
        cli(argv)
    assert not (tmp_path / "part.mdl").exists()
    printed = _run(cli, argv + ["--allow-partial"])
    assert printed.startswith("warning: reducing 1 acc files with shard specs [(1, 2)]")
    assert (tmp_path / "part.mdl").exists()


@pytest.mark.parametrize("batch_size", [512, 2])
def test_shard_batches(workdir, tmp_path, monkeypatch, batch_size):
    """A 5-utterance shard with the default --batch-size 512 scores one
    batch of 5, not 512 zero-padded rows; with --batch-size 2 it scores
    3 batches.  Both give the full batch's statistics and ELBO."""
    root = workdir
    shapes = []
    estep = vbi.elbo_and_stats

    def spy(model, data, datasize=None, mask=None):
        shapes.append(tuple(data.shape[:2]))
        return estep(model, data, datasize, mask)

    monkeypatch.setattr(vbi, "elbo_and_stats", spy)
    out = tmp_path / "whole.acc"
    assert cli(["hmm", "accumulate", str(root / "init.mdl"), str(root / "feats.npz"), str(out),
                "--batch-size", str(batch_size)] + CPU) == 0
    lengths = [v.shape[0] for v in np.load(root / "feats.npz").values()]
    if batch_size == 512:
        assert shapes == [(5, max(lengths))]
    else:
        assert shapes == [(2, max(lengths[:2])), (2, max(lengths[2:4])), (1, lengths[4])]
    payload = load_model(out, device="cpu")
    model = load_model(root / "init.mdl", device="cpu")
    x, m = _full_batch(root)
    with torch.no_grad():
        elbo, acc = estep(model, x, mask=m)
    for (name, a), (_, b) in zip(_leaves(payload["acc"]), _leaves(acc)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5, err_msg=name)
    assert abs(payload["elbo"] - elbo.item()) / float(m.sum()) < 1e-5


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_map_reduce_matches_jax(workdir, tmp_path):
    """The port's shards and update from the carried ``init.mdl`` against
    the JAX verbs' on the JAX ``init.mdl``: the shard and reduced ELBO
    per frame within 1e-4, the updated loop within rtol 2e-4, atol 1e-5."""
    root = workdir
    printed = json.loads((root / "printed.json").read_text())
    for i in (1, 2):
        assert abs(_per_frame(printed[f"port_acc{i}"]) - _per_frame(printed[f"acc{i}"])) <= 1e-4
        frames = re.search(r"(\d+) frames", printed[f"acc{i}"]).group(1)
        assert f"{frames} frames" in printed[f"port_acc{i}"]
    out = tmp_path / "mr.mdl"
    port_update = _run(cli, ["hmm", "update", str(root / "init.mdl"), str(out),
                             str(root / "shard1.acc"), str(root / "shard2.acc")] + CPU)
    assert abs(_per_frame(port_update) - _per_frame(printed["update"])) <= 1e-4
    got = load_model(out, device="cpu").to_numpy()
    want = phone_loop_to_numpy(jax_load_model(root / "jax_mr.mdl"))
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_allclose(got[key], value, rtol=2e-4, atol=1e-5, err_msg=key)
        else:
            assert got[key] == value, key


def test_acc_files_do_not_cross_packages(workdir):
    """A JAX ``.acc`` is not the port's format and does not load."""
    with pytest.raises(Exception):
        load_model(workdir / "jax_shard1.acc", device="cpu")
