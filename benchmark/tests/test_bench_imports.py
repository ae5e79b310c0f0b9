"""Nothing a run of the benchmark loads is JAX or the JAX package, and the
plain reference loads nothing of the program.  Module names are compared
by their whole top-level name (the part before the first dot), so the
port, whose name begins with the JAX package's, is not taken for it."""

import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
TOP = "sorted({m.split('.')[0] for m in sys.modules})"


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
                          f"{code}\nprint(__import__('json').dumps({TOP}))"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    modules = _loaded(
        "import pkgutil, importlib, time, benchmark\n"
        "from benchmark import harness\n"
        "for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "for p in (harness.HERE / 'metrics').glob('*.py'): harness.reader(p.stem)\n"
        "for w in ('aud-train', 'aud-decode'):\n"
        "    harness.run(w, 5, 0.2, False, 'cpu', time.perf_counter(),\n"
        "                {'utterances': 2, 'min_frames': 8, 'max_frames': 10})")
    assert "beer_tpu_torch" in modules and "torch" in modules
    assert not set(modules) & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    modules = _loaded("import benchmark.reference.common, benchmark.reference.phone_loop, "
                      "benchmark.reference.hmm, benchmark.checks, benchmark.corpus")
    assert "beer_tpu_torch" not in modules
    assert not set(modules) & set(harness.FORBIDDEN)


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "beer_tpu_torch_fake.sub", sys)
    assert "beer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "beer_tpu.fake", sys)
    assert "beer_tpu" in harness.forbidden_modules()
