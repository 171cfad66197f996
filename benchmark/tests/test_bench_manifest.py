"""BENCHMARK.json against the benchmark's contract, and every name it
gives found as a file."""

import json
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == KEYS
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        seen = [n for g, n in names if g == group]
        assert len(seen) == len(set(seen))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entry_keys(manifest, group, keys):
    for entry in manifest[group]:
        assert set(entry) - {"workloads"} == keys, entry["name"]
        for k in ("why", "layer", "source"):
            if k in entry and group != "end_to_end" and \
                    not (group == "per_layer" and k == "source"):
                assert _line(entry[k]), (entry["name"], k)


def test_files_found_by_name(manifest):
    for c in manifest["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] == []
        assert _line(c["source"])
    for w in manifest["workloads"]:
        traffic = json.loads((BENCH / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in manifest["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_cells(manifest):
    cells = manifest["workloads"]
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in manifest["configs"]}
    assert {w["config"] for w in cells} == configs
    four = sum(w["chips"] == 4 for w in cells)
    assert all(w["chips"] in (1, 4) for w in cells)
    assert four <= max(1, len(cells) // 4)
    assert 1 <= len(cells) <= 24


def _cells_of(manifest, metric):
    if "workloads" in metric:
        return set(metric["workloads"])
    return {w["name"] for w in manifest["workloads"]}


def test_every_cell_reports(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert "workloads" not in e2e["setup_s"]
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in manifest["workloads"]:
        name = w["name"]
        others = [m for m in e2e.values() if m["name"] != "setup_s"
                  and name in _cells_of(manifest, m)]
        layers = [m for m in manifest["per_layer"]
                  if name in _cells_of(manifest, m)]
        assert others and layers, name


def test_per_layer_moves_a_metric_its_cells_report(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _cells_of(manifest, m) <= _cells_of(manifest, e2e[m["moves"]])
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values()), layers


def test_check_budget_fits(manifest):
    rs = manifest["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("evidence,value", [
    ({"kind": "train", "evals": 9, "iters": 2}, 4.5),
    ({"kind": "train", "evals": 3, "iters": 0}, None),
    ({"kind": "serve", "requests": 10}, None),
])
def test_evals_per_iter_reader(evidence, value):
    import harness

    assert harness.reader("optim.evals_per_iter").read(evidence) == value
