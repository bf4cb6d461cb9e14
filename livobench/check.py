"""What decides `correct`: the named checks of the cell's configuration,
each holding part of the port to the plain reference (`livobench/reference/`).

A check is a module `livobench/checks/<name>.py`, loaded by name. It gives:

- `NUMBERS`: the names of the numbers it returns; a limits file may name
  only numbers of the cell's checks;
- `HOLDS`: the mechanisms it holds to a reference (see `mechanisms`);
- `Keeper(tree)`: what it keeps of the program, `tree` the configuration's
  tree. `Checks` below keeps the moments and calls every keeper at them,
  outside the latencies, each hook the keeper has of these, `group` the
  ordinal of the LIO update's group: `first_lio(pipe, group, info)` after
  the program's first LIO update, `before_lio(pipe, group)` and
  `after_lio(pipe, group, info)` around each checked LIO update of the
  window, `after_vio(pipe, group)` after the VIO update that follows one
  of these LIO updates (cameras only) or `drop_vio(group)` where the next
  group is not an image group, and `after_window(pipe)` once the window
  has closed, before the program is freed. A back end whose results
  arrive on a worker thread is drained and kept there;
- `gaps(rcfg, tree, pool, kept, device, arith, log, shared) -> {number:
  value}`: the comparison, `kept` its own keeper and `shared` the run's
  `Shared`. With the sound arithmetic (`sound(arith)`) it holds the
  program's answers to the reference's; with another (`tf32_arith()`, the
  control) it puts the reference computed in that arithmetic in the
  program's place;
- optionally `replay(rcfg, pool, kept, shared, device, arith)`: the
  reference's replay of the checked LIO updates, which `shared.replay`
  makes once an arithmetic for every check that follows an update on from
  it (the `lio` check gives it); one named check at most gives it. A
  check that reads it sets `READS_REPLAY = True` (`vio`).

A configuration file names its checks under `checks`; without it they are
`lio`, and `vio` where the camera is on. A check that does not exist, two
that give a replay, one that reads a replay none gives, or a mechanism
that the configuration turns on and no named check holds, stop the run
before the pool is built.
"""

from __future__ import annotations

import importlib.util
import math
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

from livobench.reference.arith import Arith

CHECKS = Path(__file__).resolve().parent / "checks"
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")

# The program's voxel arena marks an empty slot's first key (meta rows [kx,
# ky, kz, stamp, n, s1x, s1y, s1z] per slot) with this value.
ARENA_EMPTY = float(1 << 26)


def clone(tup):
    """A copy in host memory of a tuple of tensors, so that the kept
    states do not count in the card's memory peak."""
    return tuple(x.detach().to("cpu", copy=True) for x in tup)


def tf32_arith() -> Arith:
    """TF32 matmuls: the control of a float32 configuration (TF32 off)."""
    return Arith(torch.float32, tf32=True)


def sound(arith: Arith) -> bool:
    """Whether `arith` is the reference's own arithmetic (float64, exact
    matmuls), so that the program's answers are the ones compared."""
    return arith.dtype == torch.float64 and not arith.tf32


def mechanisms(tree: dict, rcfg) -> List[str]:
    """What the configuration turns on, each of which some named check has
    to hold to a reference: the LIO measurement model (`lio.<model>`),
    the camera (`vio`), the STD loop back end (`loop`), GNSS fusion
    (`gnss`) and the loop's LightGlue visual verification (`lightglue`)."""
    on = [f"lio.{rcfg.lio.measurement_model}"]
    if rcfg.vio.img_enable:
        on.append("vio")
    if (tree.get("std") or {}).get("loop_en") or tree.get("loop_enable"):
        on.append("loop")
    if (tree.get("gnss") or {}).get("gnss_en"):
        on.append("gnss")
    if any((tree.get(s) or {}).get("visual_verify_en") for s in ("std", "lightglue")):
        on.append("lightglue")
    return on


def load(name: str, where: Path = CHECKS):
    """The module livobench/checks/<name>.py (or <where>/<name>.py)."""
    path = Path(where) / f"{name}.py"
    if not (isinstance(name, str) and _NAME.match(name) and path.is_file()):
        raise SystemExit(f"livobench: no check {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"livobench_check_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


class Shared:
    """What the checks of one run share: the group of the program's first
    LIO update (`start`), those of the window's checked LIO updates
    (`cycles`, in order), and the reference's replay of them."""

    def __init__(self):
        self.start: Optional[int] = None
        self.cycles: List[int] = []
        self._make = None  # arith -> the replay; `Checks.gaps` sets it once the window has closed
        self._replays: Dict[tuple, object] = {}

    def replay(self, arith: Arith):
        """The replay in `arith` of the check that gives one, made once."""
        if self._make is None:
            raise RuntimeError("no named check gives a replay of the LIO updates")
        key = (arith.dtype, arith.tf32)
        if key not in self._replays:
            self._replays[key] = self._make(arith)
        return self._replays[key]


class Checks:
    """The cell's checks, composed: their keepers, called at the moments
    below, and their numbers.

    The moments: the program's first LIO update (set-up), and in the
    window the first LIO update at or after each of `at_s` seconds, then
    the VIO update right after it when the camera is on."""

    def __init__(self, config_file: dict, rcfg, at_s: List[float], where: Path = CHECKS):
        tree = config_file["config"]
        names = (list(config_file["checks"]) if "checks" in config_file
                 else ["lio"] + (["vio"] if rcfg.vio.img_enable else []))
        self.modules = {n: load(n, where) for n in names}
        replays = [n for n, mod in self.modules.items() if hasattr(mod, "replay")]
        if len(replays) > 1:
            raise SystemExit(f"livobench: the checks {', '.join(replays)} each give a replay; one may")
        readers = [n for n, mod in self.modules.items() if getattr(mod, "READS_REPLAY", False)]
        if readers and not replays:
            raise SystemExit(f"livobench: the checks {', '.join(readers)} read the replay of the LIO updates, "
                             f"which no named check gives (lio does)")
        self.replayer = replays[0] if replays else None
        held = {m for mod in self.modules.values() for m in mod.HOLDS}
        loose = [m for m in mechanisms(tree, rcfg) if m not in held]
        if loose:
            raise SystemExit(f"livobench: the configuration turns on {', '.join(loose)}, which no named "
                             f"check ({', '.join(names) or 'none'}) holds to a reference")
        self.numbers = [n for mod in self.modules.values() for n in mod.NUMBERS]
        self.keepers = {n: mod.Keeper(tree) for n, mod in self.modules.items()}
        self.shared = Shared()
        self.at_s = at_s
        self.camera = bool(rcfg.vio.img_enable)
        self._open: Optional[int] = None  # a LIO group kept before its update, not yet after
        self._want_vio: Optional[int] = None  # the group a VIO update to keep would have
        self._vio_of: Optional[int] = None  # the LIO group that VIO update follows

    @property
    def start(self) -> Optional[int]:
        return self.shared.start

    @property
    def cycles(self) -> List[int]:
        return self.shared.cycles

    @property
    def open(self) -> Optional[int]:
        return self._open

    def _each(self, hook: str, *args):
        for k in self.keepers.values():
            if hasattr(k, hook):
                getattr(k, hook)(*args)

    def _next_vio(self, group: int):
        self._want_vio, self._vio_of = (group + 1, group) if self.camera else (None, None)

    def due(self, window_t: float) -> bool:
        return len(self.cycles) < len(self.at_s) and window_t >= self.at_s[len(self.cycles)]

    def first_lio(self, pipe, group: int, info):
        self.shared.start = group
        self._each("first_lio", pipe, group, info)
        self._next_vio(group)

    def before_lio(self, pipe, group: int):
        self._each("before_lio", pipe, group)
        self._open = group
        self.shared.cycles.append(group)

    def after_lio(self, pipe, info):
        """`info` is what the update returned (its LioInfo)."""
        group, self._open = self._open, None
        self._each("after_lio", pipe, group, info)
        self._next_vio(group)

    def wants_vio(self, group: int) -> bool:
        return self._want_vio is not None and group == self._want_vio

    def after_vio(self, pipe):
        self._each("after_vio", pipe, self._vio_of)
        self._want_vio = self._vio_of = None

    def drop_vio(self):
        """The group after a kept LIO update was not an image group."""
        self._each("drop_vio", self._vio_of)
        self._want_vio = self._vio_of = None

    def after_window(self, pipe):
        self._each("after_window", pipe)

    def gaps(self, rcfg, tree, pool, device, arith: Arith = None, log=None) -> Dict[str, float]:
        """Every check's numbers, in the order the checks are named."""
        arith = arith or Arith()
        if self.replayer is not None and self.shared._make is None:
            give, kept = self.modules[self.replayer].replay, self.keepers[self.replayer]
            self.shared._make = lambda ar: give(rcfg, pool, kept, self.shared, device, ar)
        out: Dict[str, float] = {}
        for n, mod in self.modules.items():
            got = mod.gaps(rcfg, tree, pool, self.keepers[n], device, arith, log, self.shared)
            stray = set(got) - set(mod.NUMBERS)
            if stray:
                raise RuntimeError(f"check {n} returned {sorted(stray)}, not among its NUMBERS")
            out.update(got)
        return out


# ---------------------------------------------------------------------------
# What the checks share: their comparison, and the judgement.
# ---------------------------------------------------------------------------


def quantile(values: torch.Tensor, q: float) -> float:
    if values.numel() == 0:
        return 0.0
    v = torch.sort(values.flatten().double().cpu()).values
    return float(v[max(int(math.ceil(q * v.numel())) - 1, 0)])


def pose_gaps(a: dict, b: dict):
    """(|position gap| m, attitude gap rad)."""
    dp = float(torch.linalg.vector_norm(a["pos"].cpu() - b["pos"].cpu()))
    m = a["rot"].cpu().T @ b["rot"].cpu()
    w = 0.5 * torch.stack([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return dp, abs(math.atan2(float(torch.linalg.vector_norm(w)), 0.5 * (float(torch.trace(m)) - 1.0)))


def compare(got: Dict[tuple, dict], want: Dict[tuple, dict], kind: str, numbers, values, log=None,
            detail=None) -> Dict[str, List[float]]:
    """Each of `numbers` at each checked update of `kind`, in the order of
    the updates' keys: the gap between `got` (the program's answers, or the
    control's) and `want` (the reference's), as `values(a, b)` reads it.
    An update one side ran and the other did not, or ran at another group,
    is infinitely far."""
    out = {n: [] for n in numbers}
    for key in sorted(set(got) | set(want), key=str):
        a, b = got.get(key), want.get(key)
        if a is None or b is None or a["group"] != b["group"]:
            vals = (math.inf,) * len(numbers)
        else:
            vals = values(a, b)
        for n, v in zip(numbers, vals):
            out[n].append(v)
        if log is not None:
            extra = detail(a, b) if detail is not None and a is not None and b is not None else ""
            log(f"check {kind} update at group {(a or b)['group']} ({key[1]}): "
                + ", ".join(f"{n} {v:.3e}" for n, v in zip(numbers, vals)) + extra)
    return out


def largest(per_update: Dict[str, List[float]]) -> Dict[str, float]:
    """Each number's largest gap over the checked updates (0 where none ran)."""
    return {n: max(v, default=0.0) for n, v in per_update.items()}


def judge(gaps: Dict[str, float], limits: Dict[str, float]):
    """(correct, lines): every number that has a limit at or under it; one
    line per number compared, `name value limit`. A number without a limit
    is read and not compared (PERF.md says why for each)."""
    lines, ok = [], True
    for name, value in gaps.items():
        if name not in limits:
            continue
        lim = limits[name]
        good = value <= lim
        ok &= good
        lines.append((name, value, lim, good))
    return ok, lines
