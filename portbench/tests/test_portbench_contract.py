"""BENCHMARK.json keeps to the contract's names and units, and every cell's
configuration, scene recipe, traffic, limits and metric readers are found
by name."""

import os
import re

from portbench.core import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def bench():
    return common.load_bench()


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in b["paths"])
    assert len(b["command"]) <= 32
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units():
    b = bench()
    names = []
    for c in b["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_finds_its_files():
    b = bench()
    for w in b["workloads"]:
        wl, conf, traffic = common.cell(b, w["name"])
        assert os.path.isfile(os.path.join(common.ROOT, conf["file"]))
        assert conf["file"].startswith("portbench/")
        assert common.scene_recipe(conf["file"])["layout"] in ("scannet", "semantic_kitti")
        assert traffic["mode"] in ("train", "online", "eval")
        assert common.limits(w["name"])
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(common.BENCH, "metrics", f"{m['name']}.py"))
        for w in m.get("workloads", []):
            assert any(x["name"] == w for x in b["workloads"])


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    b = bench()
    for w in b["workloads"]:
        e2e = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in e2e}
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"])
