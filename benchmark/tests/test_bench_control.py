"""The check that decides ``correct`` has to fail what it guards against.

* The control: the plain reference put in the program's place, computed
  one precision below the configuration's float32 (TF32 products), fails
  at least one of the cell's numbers.
* The timed path broken underneath a whole run (the look for a card
  skipped, the rest as the benchmark runs it): a step that returns its
  state unchanged, half of the batch left out with the other half's terms
  doubled, an answer altered where it is produced — each run reads
  ``correct`` false.  One chip: there is no exchange between chips to
  leave out.

At a size a test run holds, on the CPU, where the program takes its
kernels' plain versions; on the card ``benchmark/control.py`` reads the
same at the cells' own size.
"""

import time

import pytest
import torch

from benchmark import control, harness

SIZE = {"utterances": 24, "min_frames": 60, "max_frames": 120}
SEEDS = (2**31 + 101, 7)


def _run(cell, seed=SEEDS[0]):
    result, _ = harness.run(cell, seed, 0.1, False, "cpu", time.perf_counter(), SIZE)
    return result


def _failed(readings, cell):
    limits = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")["limits"]
    return [k for k in limits if not readings[k] <= limits[k]]


@pytest.mark.parametrize("cell", ["aud-train", "hmm-train", "aud-decode"])
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["aud-train", "hmm-train", "aud-decode"])
def test_control_fails(cell, seed):
    assert _failed(control.readings(cell, seed, "control", "cpu", SIZE), cell)


@pytest.fixture
def vbi():
    from beer_tpu_torch import vbi

    return vbi


@pytest.mark.parametrize("cell", ["aud-train", "hmm-train"])
def test_unchanged_state_fails(cell, vbi, monkeypatch):
    def step(model, x, mask=None, **kw):
        return vbi.elbo_and_stats(model, x, mask=mask)[0], model

    monkeypatch.setattr(vbi, "vb_step", step)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["aud-train", "hmm-train"])
def test_half_batch_fails(cell, vbi, monkeypatch):
    real = vbi.vb_step

    def step(model, x, mask=None, **kw):
        half = x.shape[0] // 2
        return real(model, x[:half], datasize=x.shape[0], mask=mask[:half])

    monkeypatch.setattr(vbi, "vb_step", step)
    assert not _run(cell)["correct"]


def test_altered_answer_fails(monkeypatch):
    from benchmark.families import phone_loop

    real = phone_loop.decode

    def decode(model, x, mask):
        labels, scores = real(model, x, mask)
        labels = labels.clone()
        labels[:, 0] = (labels[:, 0] + 1) % model.n_units
        return labels, scores

    monkeypatch.setattr(phone_loop, "decode", decode)
    assert not _run("aud-decode")["correct"]


def test_half_batch_decode_fails(monkeypatch):
    from benchmark.families import phone_loop

    real = phone_loop.decode

    def decode(model, x, mask):
        half = x.shape[0] // 2
        labels, scores = real(model, x[:half], mask[:half])
        return (torch.cat([labels, torch.zeros_like(labels)]), torch.cat([scores, scores]))

    monkeypatch.setattr(phone_loop, "decode", decode)
    assert not _run("aud-decode")["correct"]
