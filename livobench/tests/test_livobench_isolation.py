"""What the benchmark loads: never JAX or the JAX package, and a reference
that takes nothing from the port. Top-level module names compared whole
(the port's name begins with the JAX package's)."""

import ast
import json
import os
import shutil
import subprocess
import sys


from livobench import harness

ROOT = harness.ROOT
HERE = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "fastlivo_tpu"}
REPO_SCRIPTS = {"bench", "bench_scaling", "chip_smoke", "tools"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _loaded(code):
    """Top-level names in sys.modules after `code`, in a fresh interpreter."""
    prog = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_sources_import_neither_jax_nor_the_repos_scripts():
    for path in HERE.rglob("*.py"):
        if "tests" in path.relative_to(HERE).parts:
            continue
        names = set(_imports(path))
        assert not names & FORBIDDEN, path
        assert not names & REPO_SCRIPTS, path
        if {"reference", "checks"} & set(path.relative_to(HERE).parts) or path.name in ("pool.py", "render.py", "stats.py"):
            assert "fastlivo_tpu_torch" not in names, path


def test_the_runner_and_the_port_load_no_jax():
    loaded = _loaded(
        "import livobench.harness as h, livobench.check, livobench.control, livobench.profiling\n"
        "import fastlivo_tpu_torch.models.pipeline, fastlivo_tpu_torch.io.sync\n"
        "for m in h.load_json(h.ROOT / 'BENCHMARK.json')['per_layer']: h.reader(m['name'])\n"
        "for p in (h.HERE / 'checks').glob('*.py'): livobench.check.load(p.stem)"
    )
    assert "fastlivo_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = sorted(p.stem for p in (HERE / "reference").glob("*.py") if p.stem != "__init__")
    loaded = _loaded("import livobench.pool, livobench.render, livobench.stats\n" + "\n".join(
        f"import livobench.reference.{m}" for m in mods))
    assert not loaded & (FORBIDDEN | {"fastlivo_tpu_torch"})


def test_a_window_that_loaded_jax_is_refused(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib")
    assert harness.forbidden_modules() == []


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "livobench/run.py", "--workload", "avia_lio_f64.handheld_room",
         "--seed", "3000000007", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def test_without_a_card_the_runner_fails_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_benchmark_alone_is_not_a_system_under_test(tmp_path):
    """A directory with only BENCHMARK.json and livobench/: no port to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "livobench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.');"
         "from livobench.tests import small; small.run_small(small.ROOM)"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "fastlivo_tpu_torch" in out.stderr
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
