"""The port stands alone: fastlivo_tpu_torch (parallel/ included) and
chip_smoke.py import with jax blocked and never import the JAX package; a
CPU call never launches the CUDA kernel; chip_smoke.py refuses to run
without a GPU; multi-device configurations raise where the process group
does not fit them."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
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
                "io.rosbag", "io.lz4f", "io.preprocess", "io.features", "native", "ops.frustum",
                "parallel", "parallel.axis", "parallel.sharded", "parallel.distributed",
                "parallel.dryrun", "backend.train_matcher", "backend.optim"):
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


@pytest.mark.parametrize("name", ["train_matcher.main", "superpoint_from_numpy", "lightglue_from_numpy",
                                  "build_dataset", "adversarial_pair"])
def test_training_entry_points_need_a_gpu_unless_told(name):
    """The training path follows the device rule: `python -m
    fastlivo_tpu_torch.backend.train_matcher` without `--device cpu`, the
    converters that make modules from `init_*` weights (NumPy, device-free)
    and the dataset and evaluation renderers mean CUDA and raise without a
    GPU; `device="cpu"` runs."""
    from fastlivo_tpu_torch import convert
    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl
    from fastlivo_tpu_torch.backend import train_matcher as tm

    sp_np, lg_np = spl.init_superpoint(0), spl.init_lightglue(0, n_layers=1)
    assert all(isinstance(v, np.ndarray) for v in (*sp_np.values(), *lg_np.values()))
    make = {
        "train_matcher.main": lambda **kw: tm.main(["--no-save", "--pairs", "1"] + (
            ["--device", kw["device"]] if kw else [])),
        "superpoint_from_numpy": lambda **kw: convert.superpoint_from_numpy(sp_np, **kw),
        "lightglue_from_numpy": lambda **kw: convert.lightglue_from_numpy(lg_np, **kw),
        "build_dataset": lambda **kw: tm.build_dataset(1, 0, chunk=2, **kw),
        "adversarial_pair": lambda **kw: tm.adversarial_pair(**kw),
    }[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    if name != "train_matcher.main":  # its CPU run is tests/test_torch_train_matcher.py's
        make(device="cpu")


@pytest.mark.parametrize(
    "setting,match",
    [
        ({"parallel.n_devices": 2}, r"n_devices is 2 but no torch.distributed process group .* world of 1"),
        ({"parallel.n_devices": 2, "parallel.n_hosts": 2}, r"n_hosts > 1 requires parallel.map_sharded"),
        ({"parallel.n_devices": 3}, r"lio.max_points \(16384\) must be divisible by parallel.n_devices \(3\)"),
        ({"parallel.n_devices": 2, "parallel.map_sharded": True},
         r"n_devices is 2 but no torch.distributed process group .* world of 1"),
        ({"lio.scan_batch": 4}, r"lio.scan_batch is 4; .* supports only lio.scan_batch 1"),
        ({"lio.scan_batch": 0}, r"lio.scan_batch is 0; .* supports only lio.scan_batch 1"),
    ],
    ids=["no_group", "n_hosts_without_map_sharded", "budget_not_divisible", "no_group_map_sharded",
         "scan_batch_4", "scan_batch_0"],
)
def test_out_of_scope_switches_raise(setting, match):
    """Multi-device configurations raise, never degrade to one rank, where
    the world does not fit them: n_devices > 1 outside a process group of
    that size (naming both sizes), n_hosts > 1 without map_sharded, and a
    point budget the world size does not divide; and lio.scan_batch other
    than 1 (the port reads each update's summary as the update ends)."""
    from fastlivo_tpu_torch.models.pipeline import LivoPipeline
    from fastlivo_tpu_torch.utils.config import load_config

    cfg = load_config(None, {"map.capacity": 1 << 10, "vio.img_enable": False, **setting})
    with pytest.raises(ValueError, match=match):
        LivoPipeline(cfg, device="cpu")


def test_out_of_scope_runner_and_reanchor_raise(tmp_path):
    """No NotImplementedError is left in the port; map_sharded without a
    process group runs on one device (as in the JAX package); feature
    extraction runs, and reanchor_map, without a loop back end, has nothing
    to apply."""
    from fastlivo_tpu_torch import run
    from fastlivo_tpu_torch.io import logio, synthetic
    from fastlivo_tpu_torch.models.pipeline import LivoPipeline
    from fastlivo_tpu_torch.utils.config import load_config

    for path in PKG.rglob("*.py"):
        text = path.read_text()
        assert "NotImplementedError" not in text and "_not_ported" not in text, path
    one = LivoPipeline(load_config(None, {"map.capacity": 1 << 10, "vio.img_enable": False,
                                          "parallel.map_sharded": True}), device="cpu")
    assert one.mesh is None and one.n_map_shards == 1 and not one.step_cfg.map_sharded
    cfg = load_config(None, {"map.capacity": 1 << 10, "vio.img_enable": False,
                             "preprocess.feature_extract_en": True, "imu.init_count": 5,
                             "lio.max_points": 1024, "imu.imu_int_frame": 32})
    assert LivoPipeline(cfg, device="cpu").reanchor_map() is False
    log = str(tmp_path / "short.flvo")
    logio.write_sequence(log, synthetic.generate(duration=0.6, imu_rate=100.0, pts_per_scan=500, seed=1,
                                                 device="cpu"))
    pipe = run.run_log(log, cfg, progress=False, device="cpu")
    assert len(pipe.timer.samples["features"]) == 6


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
    assert {"axis.py", "sharded.py", "distributed.py", "dryrun.py"} <= {
        p.name for p in _port_sources() if p.parent.name == "parallel"
    }
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
    from fastlivo_tpu_torch.ops import image
    from fastlivo_tpu_torch.utils import timing

    before = timing.counters()
    img = torch.arange(40 * 50, dtype=torch.float32).reshape(40, 50)
    out = image.extract_windows(img, torch.tensor([[-3, 2], [45, 30]], dtype=torch.int32), 9, 4)
    assert out.shape == (2, 9, 9)
    assert "extract_windows.launches" not in timing.counter_delta(timing.counters(), before)


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
