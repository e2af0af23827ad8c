"""BENCHMARK.json and the files it names."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level():
    assert set(MAN) == KEYS
    assert 1 <= MAN["run_seconds"] <= 51
    n = len(MAN["workloads"])
    assert 2 + 14 * 24 > 0
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert n >= 1 and all(w["chips"] == 1 for w in MAN["workloads"])
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert os.path.isdir(os.path.join(ROOT, p))


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]


def test_every_cell_finds_its_files():
    for w in MAN["workloads"]:
        conf = next(c for c in MAN["configs"] if c["name"] == w["config"])
        assert os.path.exists(os.path.join(ROOT, conf["file"]))
        for d, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(ROOT, "benchmark", d,
                                               name + ".json"))
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        traffic = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                              w["traffic"] + ".json")))
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "motion", traffic["motion"]["kind"] + ".py"))


def test_metrics():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers <= {"pipeline", "tracking", "mapping", "kernels",
                      "device"}
