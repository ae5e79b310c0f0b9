"""The ``svae-train`` cell at a size a test run holds, on the CPU, where
the program takes its kernels' plain versions (``benchmark/control_svae.py``
reads the same at the cell's own size on the card):

* a whole run reads ``correct``, with the cell's metrics and checks;
* the control (the reference in the program's place with TF32 products)
  fails at least one number; each fault fails its own: half of each
  minibatch with its data terms doubled, the Fisher backward dropped,
  Adam's step skipped, the conjugate update skipped — each also reads
  ``correct`` false in a whole run;
* the traced stretch's step is the timed step, bit for bit;
* the work counts against a hand count;
* each of the cell's readers returns None on a trace without its spans
  or totals (a program that opens none, or another task's trace) and its
  hand-worked number on a synthetic trace with them;
* the reference loads nothing of the program.
"""

import functools
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import control_svae, harness, peaks, tracing
from benchmark.families import svae as family
from benchmark.tasks import svae_train as task

CELL = "svae-train"
# minibatches of 8 rows of 20–40 frames: at a few frames a minibatch some
# gradients are rounding-sized, Adam's first step (lr·sign(g)) reverses for
# them, and the later steps' ELBO moves past its limit on some seeds
SIZE = {"utterances": 32, "min_frames": 20, "max_frames": 40, "minibatch": 8, "datasize": 32}
SEEDS = (2**31 + 101, 7)
READERS = ("mfu_pct.svae", "forward_roofline.svae", "backward_roofline.svae",
           "prior_roofline.svae", "idle_pct.svae", "program_idle_pct.svae", "nnet_padding_pct.svae")
FAULTS = {"half": "grad_gap", "nofisher": "grad_gap", "noadam": "param_gap",
          "noupdate": "change_gap"}
LIMITS = harness.load_json(harness.HERE / "workloads" / f"{CELL}.json")["limits"]


def _run(seed=SEEDS[0]):
    result, lines = harness.run(CELL, seed, 0.1, False, "cpu", time.perf_counter(), SIZE)
    return result, lines


def test_sound_run_is_correct():
    result, lines = _run()
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert set(result["checks"]) == set(LIMITS)
    assert [ln.split(":")[0] for ln in lines[-len(LIMITS):]] == [f"check {k}" for k in LIMITS]
    json.dumps(result, allow_nan=False)


def test_the_cell_lists_its_readers():
    names = {m["name"] for m in harness.cell_metrics("per_layer", CELL)}
    assert names == set(READERS)
    assert {m["name"] for m in harness.cell_metrics("end_to_end", CELL)} == {
        "train_frames_per_s", "setup_s"}


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(seed):
    r = control_svae.readings(CELL, seed, "control", "cpu", SIZE)
    assert [k for k in LIMITS if not r[k] <= LIMITS[k]]


@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_fault_fails_its_gap(kind, monkeypatch):
    r = control_svae.readings(CELL, SEEDS[0], kind, "cpu", SIZE)
    assert not r[FAULTS[kind]] <= LIMITS[FAULTS[kind]]
    if kind == "half":
        monkeypatch.setattr(task, "program_steps", functools.partial(task.program_steps, rows=0.5))
        assert not _run()[0]["correct"]
    else:
        with control_svae.fault(kind):
            assert not _run()[0]["correct"]


def test_faults_restore_the_program():
    from beer_tpu_torch.models.vae import VAE
    from beer_tpu_torch.ops.semiring_scan import PhoneLoopLogZ

    saved = [PhoneLoopLogZ.__dict__["backward"], torch.optim.Adam.__dict__["step"],
             VAE.__dict__["vb_update"]]
    for kind in FAULTS:
        with control_svae.fault(kind):
            pass
    assert saved == [PhoneLoopLogZ.__dict__["backward"], torch.optim.Adam.__dict__["step"],
                     VAE.__dict__["vb_update"]]


def test_traced_step_is_the_timed_step():
    """The traced stretch's cut of a step gives the same ELBO, weights and
    posterior as the step uncut, from the same start and noise."""
    c = harness.cell(CELL, 2**31 + 5, "cpu", SIZE)
    c.corpus = harness.corpus_mod.make(c.traffic, c.cfg, c.seed, "cpu")
    (a, opt_a, step_a, _, _), (b, opt_b, step_b, _, _) = (task.program_steps(c, 1)
                                                          for _ in range(2))
    gen_a, gen_b = (torch.Generator().manual_seed(9) for _ in range(2))
    for i in range(1, 3):
        x, m, _ = task.minibatch(c, i)
        want = float(step_a(a, x, gen_a, mask=m))
        assert task.traced_step(step_b, b, opt_b, x, m, gen_b, c.device) == want
    assert "elbo_and_stats" not in vars(b) and "step" not in vars(opt_b)
    for k, v in family.nnet_state(a).items():
        assert torch.equal(family.nnet_state(b)[k], v), k
    for k, v in family.posteriors(a).items():
        assert torch.equal(family.posteriors(b)[k], v), k


def test_counter_read_with_a_default(monkeypatch):
    from beer_tpu_torch.models import vae

    assert task.nnet_frames() == vae.NNET_FRAMES.frames
    monkeypatch.delattr(vae, "NNET_FRAMES")
    assert task.nnet_frames() is None


def test_work_counts():
    cfg = {"dim": 3, "latent_dim": 2, "hidden": [4, 5], "nsamples": 2, "components": 6,
           "units": 2}
    lens = torch.tensor([3, 5])          # N = 8 valid frames
    w = family.work(cfg, lens, 5)
    # encoder a frame 2·(3·4 + 4·5 + 2·5·2) = 104, decoder 2·(2·4 + 4·5 + 2·5·3) = 116
    gemm = 104 + 2 * 116
    # the prior a frame and sample: 4·6·4 + 20·6 + 2·2² = 224; moments and Fisher 2·6·4 = 48
    assert w["prior_flops"] == 8 * 2 * 224
    assert w["forward_flops"] == 8 * (gemm + 2 * 224 + 2 * 48)
    assert w["backward_flops"] == 8 * (2 * gemm + 2 * 48)
    assert w["step_flops"] == w["forward_flops"] + w["backward_flops"]
    params = (3 * 4 + 4) + (4 * 5 + 5) + 2 * (5 * 2 + 2) + (2 * 4 + 4) + (4 * 5 + 5) + 2 * (5 * 3 + 3)
    assert w["forward_bytes"] == 4 * (8 * (3 + 2 * 2) + params)
    assert w["backward_bytes"] == w["forward_bytes"] + 4 * params
    assert w["prior_bytes"] == 4 * 2 * 8 * (4 + 6)
    assert w["nnet_valid_frames"] == 3 * 8


# µs: window 0–1000, two steps; device busy 50–190, 220–380, 420–440 in
# each half
BENCH = [("user_annotation", name, a + off, b - a) for off in (0, 500) for name, a, b in (
    ("step", 0, 500), ("forward", 0, 200), ("backward", 200, 400), ("update", 400, 500))]
DEVICE = [("kernel", name, a + off, b - a) for off in (0, 500) for name, a, b in (
    ("void (anonymous namespace)::forward_llh_chunked_kernel<true, true>(float const*)", 50, 100),
    ("void (anonymous namespace)::estep_acc_chunked_kernel<false, true, true, true>(float)", 100, 150),
    ("sm80_xmma_gemm_f32f32", 150, 190), ("cutlass_80_simt_sgemm_256x128", 220, 380),
    ("multi_tensor_apply_kernel", 420, 440))]
PROGRAM = [("user_annotation", name, a + off, b - a) for off in (0, 500) for name, a, b in (
    ("beer.svae.encode", 10, 40), ("beer.svae.prior", 40, 160), ("beer.kernel.forward_llh_banded", 45, 50),
    ("beer.svae.backward", 200, 390), ("beer.svae.optim", 400, 450))]
# the least times a step: forward 70 µs of its 140 (FLOPs), backward 80 of
# 160 (bytes), the prior 20 of its kernels' 100 (bytes), the step 100 µs
WORK = {"forward_flops": 67e12 * 70e-6, "forward_bytes": 0.0,
        "backward_flops": 67e12 * 40e-6, "backward_bytes": 3.35e12 * 80e-6,
        "prior_flops": 67e12 * 10e-6, "prior_bytes": 3.35e12 * 20e-6,
        "step_flops": 67e12 * 100e-6, "nnet_valid_frames": 300.0}
WANT = {"mfu_pct.svae": 20.0, "forward_roofline.svae": 50.0, "backward_roofline.svae": 50.0,
        "prior_roofline.svae": 20.0, "idle_pct.svae": 36.0, "program_idle_pct.svae": 20.0,
        "nnet_padding_pct.svae": 40.0}


def _trace(tmp_path, task_name, events, totals=None):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        for cat, name, ts, dur in [("user_annotation", "window", 0, 1000)] + events]}))
    device, host, spans = tracing._read(str(path))
    window = spans.pop("window")[0]
    return tracing.Trace(task_name, 2, window, device, spans, host, WORK, peaks.H100,
                         dict(totals or {}))


def test_readers_hand_worked(tmp_path):
    t = _trace(tmp_path, task.TASK, BENCH + DEVICE + PROGRAM, {"nnet_frames": 1000})
    # idle inside the program's spans, a step: 10–50, 200–220, 380–390,
    # 400–420, 440–450, 100 µs; busy 140 + 160 + 20 µs of 500
    for name in READERS:
        assert harness.reader(name).read(t) == pytest.approx(WANT[name]), name


def test_readers_none_without_their_spans_or_totals(tmp_path):
    bare = _trace(tmp_path, task.TASK, DEVICE)
    none = {"forward_roofline.svae", "backward_roofline.svae", "prior_roofline.svae",
            "program_idle_pct.svae", "nnet_padding_pct.svae"}
    for name in READERS:
        value = harness.reader(name).read(bare)
        assert (value is None) == (name in none), name
    other = _trace(tmp_path, "train", BENCH + DEVICE + PROGRAM, {"nnet_frames": 1000})
    assert all(harness.reader(name).read(other) is None for name in READERS)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\nimport benchmark.reference.svae\n"
            "print(__import__('json').dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "beer_tpu_torch" not in modules and not set(modules) & set(harness.FORBIDDEN)


@pytest.mark.cuda
def test_traced_result_line_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = harness.run(CELL, 7, 2.0, True, "cuda", time.perf_counter(),
                            {"utterances": 64, "min_frames": 50, "max_frames": 100,
                             "minibatch": 16, "datasize": 64})
    assert result["correct"]
    assert set(result["metrics"]) == set(READERS)
    assert 0 < result["metrics"]["mfu_pct.svae"]["value"] <= 100
