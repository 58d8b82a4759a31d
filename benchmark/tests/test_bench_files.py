"""BENCHMARK.json and the files it names: every name found, every name
and unit in the allowed characters, every cell's metrics readable."""

import json
import os
import re

import pytest

from mosaicbench import harness as H

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(H.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command(spec):
    assert set(spec) == KEYS
    assert spec["paths"] == ["benchmark"]
    assert spec["command"][1].startswith("benchmark/")
    assert 1 <= spec["run_seconds"] <= 51


def test_names_units_and_lines(spec):
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [w["traffic"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for c in spec["configs"]:
        names += list(c["reduced"])
    for n in names:
        assert NAME.fullmatch(n), n
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in spec["workloads"]]
                 + [c["why"] for c in spec["configs"]]
                 + [c["source"] for c in spec["configs"]]
                 + [m["layer"] for m in spec["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds(spec):
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits"])
def test_files_found_by_name(spec, kind):
    for w in spec["workloads"]:
        name = {"configs": w["config"], "traffic": w["traffic"],
                "limits": w["name"]}[kind]
        path = os.path.join(H.BENCH_DIR, kind, f"{name}.json")
        assert os.path.exists(path), path
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(H.ROOT, c["file"]))


def test_every_cell_loads_with_its_metrics(spec):
    for w in spec["workloads"]:
        cell, config, traffic, limits, e2e, layer = H.load_cell(w["name"])
        assert H.kind_class(traffic["kind"])
        assert any(m["name"] == "setup_s" for m in e2e)
        assert len(e2e) >= 2 and layer
        for m in e2e + layer:
            assert callable(H.reader(m["name"]))
        for m in layer:
            assert m["moves"] in {x["name"] for x in e2e}


def test_compare_reports_a_missing_reading_as_null():
    """A number the run could not read fails its limit and is written as
    null, so the result line stays strict JSON."""
    from mosaicbench.reference import compare
    ok, checks = compare({"a": 1.0, "b": float("inf")}, {"a": 2, "b": 1})
    assert not ok and checks == {"a": {"value": 1.0, "limit": 2},
                                 "b": {"value": None, "limit": 1}}
    json.dumps(checks, allow_nan=False)
    ok, _ = compare({"a": 1.0}, {"a": 2, "c": 1})
    assert not ok
    with pytest.raises(KeyError):
        compare({"a": 1.0, "d": 0.0}, {"a": 2})
