"""The port stands alone: fastlivo_tpu_torch and chip_smoke.py import with
jax blocked and never import the JAX package; a CPU call never launches
the CUDA kernel; chip_smoke.py refuses to run without a GPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "fastlivo_tpu_torch"

torch.set_num_threads(1)


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['fastlivo_tpu'] = None\n"
        "import fastlivo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(fastlivo_tpu_torch.__path__, 'fastlivo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_sources_never_import_the_jax_package():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("fastlivo_tpu", "jax", "jaxlib"), f"{path}: imports {mod}"


def test_cpu_call_leaves_launch_counter_at_zero():
    from fastlivo_tpu_torch.ops import image, pallas_windows

    saved = pallas_windows.LAUNCHES["extract_windows"]
    pallas_windows.LAUNCHES["extract_windows"] = 0
    try:
        img = torch.arange(40 * 50, dtype=torch.float32).reshape(40, 50)
        out = image.extract_windows(img, torch.tensor([[-3, 2], [45, 30]], dtype=torch.int32), 9, 4)
        assert out.shape == (2, 9, 9)
        assert pallas_windows.LAUNCHES["extract_windows"] == 0
    finally:
        pallas_windows.LAUNCHES["extract_windows"] = saved


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        return  # on a GPU host the script runs for real (see README)
    env = dict(os.environ, PYTHONPATH="")
    for cwd in (REPO, tmp_path):
        script = cwd / "chip_smoke.py"
        if cwd is tmp_path:
            shutil.copy(REPO / "chip_smoke.py", script)
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
