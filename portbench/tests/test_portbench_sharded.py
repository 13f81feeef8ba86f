"""The four-card cell ``silesia-id-x4.save`` driven end to end on a CPU
mesh of four shards at a tiny size: a run of the port's own path comes
out correct, and the comparison comes out false under the control (an
encoder of its own with a 2**12-entry table) and under each fault the
cell can have, planted in the timed path: the output left as allocated,
half of it, one byte altered, one shard's records dropped (the exchange
between chips left out) and the shards assembled out of chunk order.
Then the readers of the cell's per-layer metrics on fabricated
contexts, and the command on the card, which needs four devices.

The port reads its engine's variables at import, so the cell runs in a
child interpreter of its own."""

import importlib
import json
import os
import subprocess
import sys
import types

import pytest

from portbench import run, spans

CELL = "silesia-id-x4.save"
# every card holds rows of each pass: seven chunks (the last partial,
# two rows a card, the last card one) and four stored chunks (one a card)
TINY = {"call": "save_sharded",
        "objects": [["dickens", 458751], ["x-ray", 262143]]}
FAULTS = ["control", "unchanged", "half", "altered", "dropped", "reordered"]

CHILD = r"""
import json, sys
from portbench import reference, run

cell, seed, tiny = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
CS, HEAD = 65536, 10


def records(out):
    pos, recs = HEAD, []
    while pos < len(out):
        end = pos + 4 + int.from_bytes(out[pos + 1 : pos + 4], "little")
        recs.append(out[pos:end])
        pos = end
    return recs


def by_shard(rows, lens, out):
    per, recs = rows.shape[0] // rows.mesh.size, records(out)
    return [recs[k * per : (k + 1) * per] for k in range(rows.mesh.size)]


def fault(kind):
    def wrap(entry):
        def broken(rows, lens):
            if kind == "control":
                data = rows.numpy().reshape(-1)[: int(lens.sum())]
                return reference.frame(data, table_bits=12)[0]
            out = entry(rows, lens)
            if kind == "unchanged":
                return out[:HEAD]  # the stream identifier, nothing encoded
            if kind == "half":
                return out[: len(out) // 2]
            if kind == "altered":
                b = bytearray(out)
                b[len(b) // 3] ^= 1
                return bytes(b)
            shards = by_shard(rows, lens, out)
            if kind == "dropped":  # the second card's records never came
                shards[1] = []
            else:  # the first two cards' records swapped
                shards[0], shards[1] = shards[1], shards[0]
            return out[:HEAD] + b"".join(r for s in shards for r in s)
        return broken
    return wrap


out = {}
for name in ["none"] + sys.argv[4].split(","):
    res = run.run_cell(cell, seed, 0.5, False, device="cpu",
                       entry_wrapper=None if name == "none" else fault(name),
                       traffic=dict(tiny))
    out[name] = {"correct": res["correct"], "checks": res["checks"],
                 "attempted": res["attempted"]}
print(json.dumps(out))
"""


def _cpu_env() -> dict:
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_without_a_card_the_command_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload", CELL,
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace",
                        "0"], cwd=run.ROOT, capture_output=True, text=True,
                       timeout=300, env=_cpu_env())
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_the_cell_is_four_chips_over_the_id_engine():
    spec = run.cell_spec(CELL)
    assert spec["cell"]["chips"] == 4
    assert spec["config"]["launches"]["save_sharded"] == ["crc32c"]
    assert spec["config"]["env"] == run.load_json(
        run.ROOT, "portbench", "configs", "silesia-id.json")["env"]
    assert spec["traffic"]["objects"] == run.load_json(
        run.ROOT, "portbench", "traffic", "save.json")["objects"]
    assert {m["name"] for m in spec["per_layer"]} == {
        "shard_fetch_ms_per_GB", "shard_native_ms_per_GB",
        "shard_d2h_bytes_per_byte"}


@pytest.fixture(scope="module")
def runs():
    p = subprocess.run([sys.executable, "-c", CHILD, CELL, str(2**31 + 13),
                        json.dumps(TINY), ",".join(FAULTS)], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=900,
                       env=_cpu_env())
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_sound_run_is_correct(runs):
    sound = runs["none"]
    assert sound["correct"], sound
    assert sound["checks"]["cards_idle"] == {"value": 0, "limit": 0}
    assert sound["checks"]["bad_bytes"]["value"] == 0


@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_comes_out_false(runs, fault):
    got = runs[fault]
    assert not got["correct"], got
    assert got["checks"]["bad_bytes"]["value"] > 0


MS = 10**6  # ns
ROOT = "snappy.compress_framed_from_device"
# one sharded call of 100 ms over two batches, then one plain call
SPANS = [("call", 0, 100 * MS), (ROOT, 1 * MS, 99 * MS),
         ("snappy.enqueue", 2 * MS, 10 * MS),
         ("snappy.shard_fetch", 4 * MS, 6 * MS),
         ("snappy.finish", 10 * MS, 50 * MS),
         ("snappy.shard_fetch", 11 * MS, 15 * MS),
         ("snappy.wait", 12 * MS, 13 * MS),
         ("snappy.native", 15 * MS, 45 * MS),
         ("snappy.finish", 50 * MS, 98 * MS),
         ("snappy.native", 60 * MS, 90 * MS),
         ("call", 100 * MS, 150 * MS), (ROOT, 101 * MS, 149 * MS),
         ("snappy.native", 110 * MS, 140 * MS)]


def _ctx(span_list, gb=0.5):
    return run.Context(gb=gb, spans=span_list, lo=0, hi=150 * MS, device=[],
                       launches={}, native=None, calls_per_object=[], refs=[])


def test_shard_fetch_reads_its_self_time():
    reader = run.load_module("metrics", "shard_fetch_ms_per_GB")
    # 2 ms, then 4 ms less the 1 ms wait nested in it, over 0.5 GB
    assert reader.read(_ctx(SPANS)) == pytest.approx(2 * (2 + 4 - 1))
    plain = [s for s in SPANS if s[0] != "snappy.shard_fetch"]
    assert reader.read(_ctx(plain)) is None


def test_shard_native_reads_the_sharded_calls_only():
    reader = run.load_module("metrics", "shard_native_ms_per_GB")
    # the two native spans of the sharded call; the plain call's is not
    assert reader.read(_ctx(SPANS)) == pytest.approx(2 * (30 + 30))
    plain = [s for s in SPANS if s[0] != "snappy.shard_fetch"]
    assert reader.read(_ctx(plain)) is None


def test_shard_d2h_reads_the_cards_counters(monkeypatch):
    reader = run.load_module("metrics", "shard_d2h_bytes_per_byte")
    mesh = importlib.import_module("snappy_tpu_torch.dist.mesh")
    fake = types.SimpleNamespace(COUNTERS={"bytes": 1000, "h2d_bytes": 0,
                                           "d2h_bytes": 0})
    monkeypatch.setattr(spans, "runtime", lambda: fake)
    monkeypatch.setattr(mesh, "SHARDS", {"d2h_bytes": [300, 300, 404, 0],
                                         "crc_launches": [1, 1, 1, 0]})
    assert reader.read(_ctx([])) == pytest.approx(1.004)
    monkeypatch.setattr(mesh, "SHARDS", {"d2h_bytes": [], "crc_launches": []})
    assert reader.read(_ctx([])) is None
    monkeypatch.delattr(mesh, "SHARDS")
    assert reader.read(_ctx([])) is None
    monkeypatch.setattr(spans, "runtime", lambda: None)
    assert reader.read(_ctx([])) is None


@pytest.fixture
def four_cards():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA GPUs")


@pytest.mark.cuda
def test_a_short_run_on_four_cards(four_cards):
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload", CELL,
                        "--seed", str(2**31 + 9), "--seconds", "2", "--trace",
                        "0"], cwd=run.ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["checks"]["cards_idle"]["value"] == 0
