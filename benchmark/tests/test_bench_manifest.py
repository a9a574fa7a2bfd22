"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and every per-layer metric tied to a layer, an end-to-end metric and the
cells that report it, each name found as a file."""

import json
import re

from benchmark.core import cell as cell_mod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cell_mod.BENCH_DIR
ROOT = cell_mod.ROOT


def manifest():
    return cell_mod.manifest()


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    runs = 2 + 14 * 24          # a full check at 24 cells must fit
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_units_and_entry_keys():
    m = manifest()
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for x in m["end_to_end"] + m["per_layer"]:
        names.append(x["name"])
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    names += [w["name"] for w in m["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    m = manifest()
    cells = [w["name"] for w in m["workloads"]]
    assert any(x["name"] == "setup_s" and "workloads" not in x
               for x in m["end_to_end"])
    for name in cells:
        c = cell_mod.load(name)
        assert len(c.end_to_end) >= 2 and c.per_layer
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}


def test_per_layer_metrics_move_a_metric_their_cells_report():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    layers = {}
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        assert x["workloads"] and set(x["workloads"]) <= cells
        for w in x["workloads"]:
            reported = e2e[x["moves"]].get("workloads", cells)
            assert w in reported, (x["name"], w)
        assert 1 <= len(x["layer"]) <= 200 and "\n" not in x["layer"]
        layers.setdefault(x["name"].split(".")[0], set()).add(x["layer"])
        assert (BENCH / "metrics" / f"{x['name']}.py").is_file()
        assert callable(cell_mod.reader(x["name"]))
        if x["name"].split(".")[0].endswith("_roofline"):
            assert x["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


def test_configs_state_what_the_reference_needs():
    for c in manifest()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        ref = cell_mod.reference(cfg)
        for name in ("deployment", "pressure_grid", "planck_table",
                     "check_planet"):
            assert callable(getattr(ref, name)), (ref.__name__, name)
        d = ref.deployment(cfg["helios"], {})
        assert d["nlayer"] == 105
        assert cfg["table"]["nbin"] == 385 and cfg["table"]["ny"] == 20
        assert cfg["limits"] and all(v >= 0 for v in cfg["limits"].values())
        if cfg["reference"] == "rce_premixed":
            assert set(cfg["limits"]) == {"flux_gap", "rad_residual",
                                          "adiabat_gap"}
        if "inputs" in cfg:
            assert callable(cell_mod.inputs(cfg))
