"""`correct` as a composition of named checks (`livobench/check.py`,
`livobench/checks/`), on the CPU at the tests' small size:

- the `lio` and `vio` checks give each cell the numbers the single check
  gave before them (commit d204e76, the last with one `check.py`);
- a configuration brings its own check with new files alone: a check
  module, its reference module, the configuration and the limits;
- a configuration that turns on a mechanism no named check holds stops
  before the pool is built;
- `trajectory.lap_draws`: absent, the pool is the one it was; with two
  draws, lap 1 is drawn anew over the same stamps.

The runs here are made deterministic: the harness's clock reads 1 ms
later at each read, the checked cycles are the window's first LIO
updates (`window_times` all 0), and torch's host math runs on one thread
(the last bits of a sum depend on the threads).
"""

import copy
import hashlib
import itertools
import json
import math
import shutil
import types

import numpy as np
import pytest
import torch

from livobench import check, harness, pool
from livobench.reference import lio as rlio
from livobench.tests import small

SEED = 2147483659
WINDOW_S = 0.3  # on the fixed clock: about three scan cycles

# Each cell's numbers at commit d204e76 under the same fixed clock, seed
# and size, torch on one thread.
PARENT = {
    small.ROOM_LIO: {"lio_pos_gap_m": 2.022827553647289e-09, "lio_rot_gap_rad": 6.943353660192314e-10,
                     "map_gap_m": 1.685873940435761e-07},
    small.ROOM: {"lio_pos_gap_m": 3.226670127140222e-05, "lio_rot_gap_rad": 5.435465908750615e-06,
                 "map_gap_m": 8.698799143342989e-05, "vio_pos_gap_m": 8.78361161298423e-08,
                 "vio_rot_gap_rad": 6.008860925731949e-08, "patch_gap": 0.0006403487583668266},
    small.STREET: {"lio_pos_gap_m": 9.293549154569656e-07, "lio_rot_gap_rad": 2.03113486287777e-08,
                   "map_gap_m": 1.132425507262985e-05},
}
VIO = ("vio_pos_gap_m", "vio_rot_gap_rad", "patch_gap")
# The pool of the camera room at the small size and SEED at commit d204e76:
# records in the lead-in and the lap, and a digest of kinds, stamps and data.
PARENT_POOL = (441, 2200, "16a20f488c15703d0887340d5f40e16db42acead580d6fe93a08b6d01745714e")


@pytest.fixture
def one_thread():
    """Torch's host math on one thread, for the test's length."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fixed(monkeypatch, one_thread):
    """The deterministic driving above, for the test's length."""
    ticks = itertools.count(1)
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(perf_counter=lambda: next(ticks) * 1e-3))
    monkeypatch.setattr(harness, "window_times", lambda seed, seconds, n: [0.0] * n)


def run(c: harness.Cell, size: str = None):
    """One run of the cell at the small size of configuration `size` (the
    cell's own by default)."""
    size = size or c.workload["config"]
    return harness.run_cell(c, SEED, WINDOW_S, False, "cpu", 0.0, overrides=small.SMALL[size],
                            traffic=small.small_traffic(c, size))


def every_number(c: harness.Cell) -> harness.Cell:
    """The cell with each number of its checks under an infinite limit."""
    rcfg = harness.reference_config(c.config_file["config"], small.SMALL[c.workload["config"]])
    c.limits = dict.fromkeys(check.Checks(c.config_file, rcfg, []).numbers, math.inf)
    return c


@pytest.mark.parametrize("name", sorted(PARENT))
def test_the_cells_read_what_the_single_check_read(name, fixed):
    result, lines = run(every_number(small.cell(name)))
    got = {n: v for n, v, _, _ in lines}
    assert [n for n in got if n in PARENT[name]] == list(PARENT[name])  # in the same order
    for n, want in PARENT[name].items():
        assert got[n] == pytest.approx(want, rel=1e-9, abs=0.0), n
    # The numbers the checks added: the start, one of the updates lio_pos_gap_m is the largest
    # over, and with a camera each VIO number's median over the updates, at most their largest.
    added = {"lio_start_pos_gap_m"} | ({f"{n}_median" for n in VIO} if "patch_gap" in PARENT[name] else set())
    assert set(got) - set(PARENT[name]) == added
    assert 0.0 < got["lio_start_pos_gap_m"] <= got["lio_pos_gap_m"]
    for n in added - {"lio_start_pos_gap_m"}:
        assert 0.0 < got[n] <= got[n[:-len("_median")]], n


# ---------------------------------------------------------------------------
# A configuration that brings its own check.
# ---------------------------------------------------------------------------

TOY_CHECK = '''"""A toy check: the hooks it was called at, held to the order the
harness promises (its reference, livobench/reference/toy_order.py)."""

from livobench.check import clone
from livobench.reference import toy_order

NUMBERS = ("toy_gap",)
HOLDS = ()


class Keeper:
    def __init__(self, tree):
        self.calls = []
        self.final = None

    def first_lio(self, pipe, group, info):
        self.calls.append(("first_lio", group))

    def before_lio(self, pipe, group):
        self.calls.append(("before_lio", group))

    def after_lio(self, pipe, group, info):
        self.calls.append(("after_lio", group))

    def after_vio(self, pipe, group):
        self.calls.append(("after_vio", group))

    def drop_vio(self, group):
        self.calls.append(("drop_vio", group))

    def after_window(self, pipe):
        self.calls.append(("after_window", None))
        self.final = clone(pipe.state)


def gaps(rcfg, tree, pool, kept, device, arith, log, shared):
    gap = toy_order.gap(kept.calls, kept.final, shared.start, shared.cycles)
    if log is not None:
        log(f"check toy: {len(kept.calls)} calls, toy_gap {gap}")
    return {"toy_gap": gap}
'''

TOY_REFERENCE = '''"""The order of a toy check's hooks: the program's first LIO update, each
checked LIO update of the window before and after, each with its group,
then the window's end with the program's state still there."""

import math


def gap(calls, final, start, cycles):
    pairs = [(h, g) for g in cycles for h in ("before_lio", "after_lio")]
    ok = calls == [("first_lio", start), *pairs, ("after_window", None)] and bool(cycles) and final is not None
    return 0.0 if ok else math.inf
'''


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    """A checkout of the benchmark as a later PR would leave it: the
    benchmark's files as they are, plus a toy configuration that names the
    `lio` check and a new `toy` check, the check, its reference module and
    the cell's limits. (bench, root)."""
    shutil.copytree(harness.HERE, tmp_path / "livobench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "livobench"
    conf = harness.load_json(harness.HERE / "configs" / "avia_lio_f64.json")
    conf.update(name="toy_room", checks=["lio", "toy"])
    (here / "configs" / "toy_room.json").write_text(json.dumps(conf))
    limits = harness.load_json(harness.HERE / "limits" / f"{small.ROOM_LIO}.json")
    (here / "limits" / "toy_room.handheld_room.json").write_text(json.dumps({**limits, "toy_gap": 0.0}))
    (here / "checks" / "toy.py").write_text(TOY_CHECK)
    (here / "reference" / "toy_order.py").write_text(TOY_REFERENCE)
    # The new reference module is found where a later checkout keeps it.
    import livobench.reference

    monkeypatch.setattr(livobench.reference, "__path__", [str(here / "reference"), *livobench.reference.__path__])
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    bench["configs"].append({"name": "toy_room", "file": "livobench/configs/toy_room.json"})
    bench["workloads"].append({"name": "toy_room.handheld_room", "config": "toy_room", "traffic": "handheld_room",
                               "chips": 1})
    return bench, tmp_path


def toy_cell(bench, root) -> harness.Cell:
    return harness.Cell(bench, "toy_room.handheld_room", root)


def test_a_new_check_reaches_judge_with_new_files_alone(toy_root, fixed):
    bench, root = toy_root
    c = toy_cell(bench, root)
    assert c.checks_dir == root / "livobench" / "checks" and "toy_gap" in c.limits
    result, lines = run(c, "avia_lio_f64")
    assert result["correct"], lines
    assert result["checks"]["toy_gap"] == {"value": 0.0, "limit": 0.0}
    assert list(result["checks"]) == [n for n in check.load("lio").NUMBERS + ("toy_gap",) if n in c.limits]
    # The lio check beside it reads as it reads alone.
    for n in ("lio_pos_gap_m", "map_gap_m"):
        assert result["checks"][n]["value"] == pytest.approx(PARENT[small.ROOM_LIO][n], rel=1e-9, abs=0.0)
    ok, lines = check.judge({**{n: v["value"] for n, v in result["checks"].items()}, "toy_gap": math.inf},
                            c.limits)
    assert not ok and [n for n, _, _, good in lines if not good] == ["toy_gap"]


def _no_pool(monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("the pool was built")

    monkeypatch.setattr(pool, "build_pool", refused)


def test_a_limit_no_check_returns_and_a_missing_check_stop_the_run(toy_root, monkeypatch):
    bench, root = toy_root
    _no_pool(monkeypatch)
    c = toy_cell(bench, root)
    c.limits = {**c.limits, "toy_other": 1.0}
    with pytest.raises(SystemExit, match="toy_other"):
        run(c, "avia_lio_f64")
    c = toy_cell(bench, root)
    c.config_file = {**c.config_file, "checks": ["lio", "toy", "absent"]}
    with pytest.raises(SystemExit, match="absent"):
        run(c, "avia_lio_f64")
    c.config_file = {**c.config_file, "checks": ["toy"]}  # nothing holds the point-to-plane LIO
    with pytest.raises(SystemExit, match="lio.point_to_plane"):
        run(c, "avia_lio_f64")
    (root / "livobench" / "checks" / "lio_again.py").write_text(
        (root / "livobench" / "checks" / "lio.py").read_text())
    c.config_file = {**c.config_file, "checks": ["lio", "lio_again"]}  # two replays of the LIO updates
    with pytest.raises(SystemExit, match="lio, lio_again each give a replay"):
        run(c, "avia_lio_f64")
    c.config_file = {**c.config_file, "checks": ["vio", "toy"]}  # the VIO follows a replay nothing gives
    with pytest.raises(SystemExit, match="vio read the replay"):
        run(c, "avia_lio_f64")


# ---------------------------------------------------------------------------
# Mechanisms no named check holds.
# ---------------------------------------------------------------------------

TURNED_ON = {
    "lio.surfel": ("mapping", "measurement_model", "surfel"),
    "lio.vgicp": ("mapping", "measurement_model", "vgicp"),
    "loop": ("std", "loop_en", True),
    "gnss": ("gnss", "gnss_en", 1),
    "lightglue": ("lightglue", "visual_verify_en", True),
}


@pytest.mark.parametrize("mechanism", sorted(TURNED_ON))
def test_a_mechanism_no_check_holds_stops_the_run(mechanism, monkeypatch):
    _no_pool(monkeypatch)
    c = small.cell(small.ROOM_LIO)
    section, key, value = TURNED_ON[mechanism]
    c.config_file = copy.deepcopy(c.config_file)
    c.config_file["config"].setdefault(section, {})[key] = value
    with pytest.raises(SystemExit, match=mechanism):
        run(c)


def test_the_fork_s_loop_flag_turns_the_loop_on(monkeypatch):
    _no_pool(monkeypatch)
    c = small.cell(small.ROOM_LIO)
    c.config_file = copy.deepcopy(c.config_file)
    c.config_file["config"]["loop_enable"] = 1
    with pytest.raises(SystemExit, match="loop"):
        run(c)


@pytest.mark.parametrize("name", sorted(PARENT))
def test_the_cells_turn_on_only_what_their_checks_hold(name):
    c = small.cell(name)
    rcfg = harness.reference_config(c.config_file["config"], {})
    checks = check.Checks(c.config_file, rcfg, [])
    assert list(checks.modules) == (["lio", "vio"] if rcfg.vio.img_enable else ["lio"])
    assert set(c.limits) <= set(checks.numbers)


def test_the_reference_lio_refuses_a_model_it_does_not_implement():
    p = harness.reference_config({"mapping": {"measurement_model": "surfel"}}, {})
    assert p.lio.measurement_model == "surfel" and rlio.MODELS == ("point_to_plane",)
    with pytest.raises(ValueError, match="surfel"):
        rlio.update(None, None, torch.zeros((1, 3)), None, None, None, p)


# ---------------------------------------------------------------------------
# Draws of the lap.
# ---------------------------------------------------------------------------


def _room(draws=None):
    c = small.cell(small.ROOM)
    tr = small.small_traffic(c)
    if draws is not None:
        tr["trajectory"]["lap_draws"] = draws
    cfg = harness.reference_config(c.config_file["config"], small.SMALL["avia_livo"])
    return pool.build_pool(tr, cfg, SEED, "cpu")


def _digest(records):
    h = hashlib.sha256()
    for r in records:
        h.update(f"{r.kind} {r.stamp!r}".encode())
        for x in r.data:
            h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def test_lap_draws_absent_is_the_parents_pool_and_two_draw_lap_one_anew(one_thread):
    p = _room()
    assert (len(p.lead), len(p.lap), _digest(p.lead + p.lap)) == PARENT_POOL
    two = _room(2)
    assert _digest(two.lead + two.lap) == PARENT_POOL[2]  # draw 0 is the pool as it was
    n = len(two.lap)
    stream = two.stream(with_lead=False)
    laps = [[next(stream) for _ in range(n)] for _ in range(3)]
    for a, b, c in zip(*laps):
        assert a.kind == b.kind == c.kind and b.stamp == a.stamp + two.period and c.stamp == a.stamp + 2 * two.period
        assert c.data is a.data  # lap 2 replays draw 0
    sweeps = [(a.data, b.data) for a, b in zip(laps[0], laps[1]) if a.kind == pool.LIDAR]
    assert sweeps and all(not np.array_equal(x[0], y[0]) for x, y in sweeps)  # other points
    imu = [(a.data, b.data) for a, b in zip(laps[0], laps[1]) if a.kind == pool.IMU]
    assert all(not np.array_equal(x[0], y[0]) for x, y in imu)  # other noise
    frames = [(a.data, b.data) for a, b in zip(laps[0], laps[1]) if a.kind == pool.IMG]
    assert frames and all(x is y for x, y in frames)  # the same frames
