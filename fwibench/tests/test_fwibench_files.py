"""BENCHMARK.json and the files its names point to: every cell resolves
its configuration (the sizes and the plain reference beside them), its
traffic, its limits and the readers of its metrics; names, units and
paths keep to the allowed characters; the work arithmetic parses."""
import json
import re

import pytest

from fwibench.harness import work as wk
from fwibench.tests.tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) and (ROOT / p).is_dir() for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_entries_have_their_keys_only():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text
                assert "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    cj = json.loads((ROOT / cfg["file"]).read_text())
    assert cj["name"] == cfg["name"]
    assert (ROOT / "fwibench" / "configs" / f"{cfg['name']}.py").exists()
    traffic = wk.load("traffic", w["traffic"])
    for kind in traffic["work_per_chunk"]:
        ops, n_bytes = wk.ops_bytes(kind, cj, cj["n_shots"])
        assert ops > 0 and n_bytes > 0
    limits = json.loads((ROOT / "fwibench" / "limits" / f"{cell}.json")
                        .read_text())
    assert all(isinstance(v, (int, float)) for v in limits.values())
    e2e = [m for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = [m for m in BENCH["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names
                              else [])]
    assert layer
    for m in e2e + layer:
        assert (ROOT / "fwibench" / "metrics" / f"{m['name']}.py").exists()
    for m in layer:
        assert m["moves"] in names


def test_every_config_used_and_layers_named_once():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"`{layer}`" in perf, layer


def test_kernel_patterns_match_whole_names():
    pat = re.compile(wk.load("kernels", "fwd_step_kernel")["pattern"])
    assert pat.search("void (anonymous namespace)::fwd_step_kernel<true>"
                      "(float const*, int)")
    assert not pat.search("void ac_fwd_step_kernel<true>(float const*)")
