"""The port stands alone: fastlivo_tpu_torch and chip_smoke.py import with
jax blocked and never import the JAX package; a CPU call never launches
the CUDA kernel; chip_smoke.py refuses to run without a GPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
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
    assert int(out.stdout.strip()) >= 30


def test_every_module_is_walked():
    """The import check above covers the host pipeline and the CLI."""
    import pkgutil

    import fastlivo_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(fastlivo_tpu_torch.__path__, "fastlivo_tpu_torch.")}
    for mod in ("run", "ops.plane", "io.sensors", "io.sync", "io.logio", "io.export", "io.synthetic",
                "utils.config", "utils.checkpoint", "utils.timing", "utils.metrics", "ops.earth",
                "models.gnss", "io.annotate", "backend.std_loop", "backend.pose_graph",
                "backend.loop_manager", "backend.superpoint_lightglue", "backend.visual_verify",
                "io.rosbag", "io.lz4f", "io.preprocess", "io.features", "native", "ops.frustum"):
        assert f"fastlivo_tpu_torch.{mod}" in names


def test_pipeline_needs_a_gpu_unless_told():
    from fastlivo_tpu_torch.models.pipeline import LivoPipeline
    from fastlivo_tpu_torch.utils.config import load_config

    cfg = load_config(str(REPO / "configs" / "avia_livo.yaml"))
    if torch.cuda.is_available():
        assert LivoPipeline(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LivoPipeline(cfg)


@pytest.mark.parametrize(
    "name",
    ["PatchMatcher", "OrientedPatchMatcher", "SuperPointLightGlue", "default_matcher",
     "StdLoopDetector", "LoopBackend", "GnssFusion", "align_trajectory"],
)
def test_back_end_needs_a_gpu_unless_told(name):
    """The back end's constructors and entry points follow the port's device
    rule: no `device` means CUDA, and raises without a GPU."""
    import numpy as np

    from fastlivo_tpu_torch.backend import loop_manager, std_loop
    from fastlivo_tpu_torch.backend import visual_verify as vv
    from fastlivo_tpu_torch.models import gnss
    from fastlivo_tpu_torch.utils.config import load_config

    make = {
        "PatchMatcher": lambda: vv.PatchMatcher(),
        "OrientedPatchMatcher": lambda: vv.OrientedPatchMatcher(),
        "SuperPointLightGlue": lambda: vv.SuperPointLightGlue(weights_path=vv.default_weights_paths()),
        "default_matcher": lambda: vv.default_matcher(),
        "StdLoopDetector": lambda: std_loop.StdLoopDetector(std_loop.StdConfig()),
        "LoopBackend": lambda: loop_manager.LoopBackend(
            load_config(str(REPO / "configs" / "urbannav_loop.yaml"))),
        "GnssFusion": lambda: gnss.GnssFusion(),
        "align_trajectory": lambda: gnss.align_trajectory(
            np.zeros((2, 3)), np.tile(np.eye(3), (2, 1, 1)), np.zeros((2, 3)), np.ones(3), iters=1),
    }[name]
    if torch.cuda.is_available():
        make()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize(
    "setting,item",
    [
        ({"parallel.n_devices": 2}, 14),
        ({"parallel.map_sharded": True}, 14),
        ({"parallel.n_devices": 4}, 14),
        ({"parallel.n_devices": 2, "parallel.map_sharded": True}, 14),
    ],
)
def test_out_of_scope_switches_raise(setting, item):
    """Only the multi-device switches are left unported (lio.scan_batch is
    ported: tests/test_torch_scan_batch.py)."""
    from fastlivo_tpu_torch.models.pipeline import LivoPipeline
    from fastlivo_tpu_torch.utils.config import load_config

    cfg = load_config(None, {"map.capacity": 1 << 10, "vio.img_enable": False, **setting})
    with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
        LivoPipeline(cfg, device="cpu")


def test_out_of_scope_runner_and_reanchor_raise(tmp_path):
    """The only NotImplementedErrors left in the port are the multi-device
    ones; feature extraction and scan batching run, and reanchor_map,
    without a loop back end, has nothing to apply."""
    from fastlivo_tpu_torch import run
    from fastlivo_tpu_torch.io import logio, synthetic
    from fastlivo_tpu_torch.models.pipeline import LivoPipeline
    from fastlivo_tpu_torch.utils.config import load_config

    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            if "raise NotImplementedError" in line or "raise _not_ported" in line:
                assert "_NO_MULTI_DEVICE" in line or "item 14" in line or ", 14)" in line, f"{path}: {line}"
    cfg = load_config(None, {"map.capacity": 1 << 10, "vio.img_enable": False, "lio.scan_batch": 0,
                             "preprocess.feature_extract_en": True, "imu.init_count": 5,
                             "lio.max_points": 1024, "imu.imu_int_frame": 32})
    assert LivoPipeline(cfg, device="cpu").reanchor_map() is False
    log = str(tmp_path / "short.flvo")
    logio.write_sequence(log, synthetic.generate(duration=0.6, imu_rate=100.0, pts_per_scan=500, seed=1,
                                                 device="cpu"))
    pipe = run.run_log(log, cfg, progress=False, device="cpu")
    assert len(pipe.timer.samples["features"]) == 6 and not pipe._pending


def test_back_end_constructs_with_jax_blocked(tmp_path):
    """The learned matcher loads the committed weights, and a pipeline with
    GNSS, the loop back end, its visual gate and the frame dump constructs
    from both shipped back-end configs, with jax and the JAX package
    blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['fastlivo_tpu'] = None\n"
        "from fastlivo_tpu_torch.backend import visual_verify as vv\n"
        "m = vv.default_matcher(device='cpu')\n"
        "assert isinstance(m, vv.SuperPointLightGlue), type(m)\n"
        "from fastlivo_tpu_torch.models.pipeline import LivoPipeline\n"
        "from fastlivo_tpu_torch.utils.config import load_config\n"
        "small = {'map.capacity': 1 << 10, 'vio.max_visual_points': 256, 'loop.visual_verify_en': True,\n"
        "         'gnss.gnss_en': True, 'loop.loop_en': True, 'runtime.img_save_en': True}\n"
        "for c in ('configs/urbannav_loop.yaml', 'configs/mars_lvig_gnss.yaml'):\n"
        "    p = LivoPipeline(load_config(c, small), device='cpu')\n"
        "    assert p.gnss is not None and p.loop_backend is not None\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


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
