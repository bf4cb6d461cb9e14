"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import copy
import json
import re

import pytest

from livobench import check, harness, pool

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def read_yaml(path):
    """The YAML subset of configs/*.yaml: comments, `key: value`, one level
    of namespaces, flow lists over several lines; YAML 1.1 scalars."""

    def scalar(v):
        v = v.strip()
        if v in ("true", "false"):
            return v == "true"
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
        return v

    out, section, pending = {}, None, None
    for raw in path.read_text().splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        if pending is not None:
            pending[2].append(line.strip())
            if "]" in line:
                where, key, parts = pending
                where[key] = [scalar(x) for x in " ".join(parts).strip("[] ").split(",") if x.strip()]
                pending = None
            continue
        key, _, value = line.strip().partition(":")
        where = out if not raw.startswith(" ") else out[section]
        if not raw.startswith(" "):
            section = key
        if not value.strip():
            out[key] = {}
        elif value.strip().startswith("[") and "]" not in value:
            pending = (where, key, [value.strip()])
        elif value.strip().startswith("["):
            where[key] = [scalar(x) for x in value.strip().strip("[]").split(",") if x.strip()]
        else:
            where[key] = scalar(value)
    return out


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_sizes():
    assert set(BENCH) == TOP
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert BENCH["command"] == ["python3", "livobench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check with 24 cells fits: 2 + 14 * 24 runs, 180 s of compile per cell.
    r = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    pairs = set()
    for w in BENCH["workloads"]:
        cell = harness.Cell(BENCH, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:  # the metric it moves is reported there too
            assert m["moves"] in reported, (w["name"], m["name"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    layers = {}
    for m in BENCH["per_layer"]:  # one layer, one name
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_each_name_has_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith("livobench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((harness.HERE / "limits" / f"{w['name']}.json").read_text())
        conf = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        checks = check.Checks(conf, harness.reference_config(conf["config"], {}), [])
        assert limits and set(limits) <= set(checks.numbers)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for p in (ROOT / "livobench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"[A-Za-z0-9_.\-/]+$", str(p.relative_to(ROOT))), p


@pytest.mark.parametrize("path", sorted((harness.HERE / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_configurations_are_the_shipped_files(path):
    """Each file holds the shipped YAML, but for the keys it lists as
    changed and the sizes it lists as assumed (`section.key`: values the
    YAML leaves to the program, not cuts); BENCHMARK.json lists the same."""
    data = json.loads(path.read_text())
    shipped = read_yaml(ROOT / data["shipped_as"])
    config = copy.deepcopy(data["config"])
    for dotted in data["assumed"]:
        *sections, key = dotted.split(".")
        where = config
        for section in sections:
            where = where[section]
        del where[key]
    assert set(config) == set(shipped)
    assert {k for k in shipped if config[k] != shipped[k]} == set(data["reduced"])
    assert data["precision"] in ("float32", "float64") if "precision" in data else True
    for c in BENCH["configs"]:
        if c["file"] == str(path.relative_to(ROOT)):
            assert c["reduced"] == data["reduced"] and c["name"] == data["name"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_traffic_laps_hold_whole_periods(w):
    tr = pool.load_traffic(w["traffic"])
    m = pool.Motion(tr["trajectory"])
    rates = [tr["lidar"]["rate_hz"], tr["imu"]["rate_hz"]] + ([tr["camera"]["rate_hz"]] if "camera" in tr else [])
    for rate in rates:
        for span in (m.lap_s, m.lap0):
            assert abs(span * rate - round(span * rate)) < 1e-9
