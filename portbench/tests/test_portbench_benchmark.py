"""BENCHMARK.json against the benchmark's contract, and the discovery of
each cell's configuration, traffic mix, call and metric readers by name.

    python3 -m pytest portbench/tests -q
"""

import json
import os
import re
import types

import pytest

from portbench import run

ROOT = run.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_lines():
    items = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    names = [i["name"] for i in items]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        kind_names = [i["name"] for i in BENCH[kind]]
        assert len(set(kind_names)) == len(kind_names)
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([i["why"] for i in BENCH["configs"] + BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for m in names.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    spec = run.cell_spec(cell)
    config = next(c for c in BENCH["configs"]
                  if c["name"] == spec["cell"]["config"])
    assert spec["config"]["name"] == config["name"]
    assert spec["config"]["source"] == config["source"]
    assert spec["config"]["reduced"] == config["reduced"]
    assert spec["cell"]["chips"] in (1, 4)
    assert spec["traffic"]["call"] in spec["config"]["launches"]
    call = run.load_module("calls", spec["traffic"]["call"])
    assert callable(call.Session) and isinstance(call.ENTRY, str)
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s", "GBps"}
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        assert callable(run.load_module("metrics", m["name"]).read)


def test_a_cell_added_as_files_is_found(tmp_path):
    """A later cell is a new entry and new files; the harness finds it
    with no edit."""
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [dict(
        BENCH["configs"][0], name="other", file="portbench/configs/other.json")]
    bench["workloads"] = BENCH["workloads"] + [dict(
        BENCH["workloads"][0], name="other.mix", config="other", traffic="mix")]
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = json.load(open(os.path.join(ROOT, "portbench/configs/silesia-id.json")))
    (tmp_path / "portbench/configs/other.json").write_text(
        json.dumps(dict(cfg, name="other")))
    (tmp_path / "portbench/traffic/mix.json").write_text(
        json.dumps({"call": "load", "objects": [["xml", 4096]]}))
    spec = run.cell_spec("other.mix", root=str(tmp_path))
    assert spec["config"]["name"] == "other"
    assert spec["traffic"]["objects"] == [["xml", 4096]]
    assert spec["per_layer"] == []  # no metric lists the new cell


def test_a_metric_added_as_a_file_reads_spans_and_bytes(tmp_path):
    """A later per-layer metric is a new reader file alone: the context
    hands it every host span and each object's reference framing."""
    (tmp_path / "portbench" / "metrics").mkdir(parents=True)
    (tmp_path / "portbench/metrics/scan_ms_per_GB.py").write_text(
        "def read(ctx):\n"
        "    ns = sum(e - s for name, s, e in ctx.spans if name == 'scan')\n"
        "    return ns / 1e6 / ctx.gb if ns else None\n"
        "def needed_bytes(ref):\n"
        "    return ref.size\n")
    reader = run.load_module("metrics", "scan_ms_per_GB", root=str(tmp_path))
    ctx = run.Context(gb=0.5, spans=[("call", 0, 10**7), ("scan", 0, 2 * 10**6),
                                     ("scan", 5 * 10**6, 6 * 10**6)],
                      calls_per_object=[2], refs=[types.SimpleNamespace(size=7)])
    assert reader.read(ctx) == pytest.approx(6.0)
    assert ctx.window_bytes(reader.needed_bytes) == 14
