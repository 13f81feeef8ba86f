"""Each cell driven end to end on the CPU at a tiny size: the command
refuses to measure without a card; a run of the port's own path comes
out correct; and the comparison comes out false under each control and
under each fault the cell can have, planted in the timed path: the
output left as allocated (a step that returns its state unchanged), the
second half of the work left out, one byte altered where it is produced.
A one-chip cell has no exchange between chips to leave out.

The port reads its engine's variables at import, so each cell runs in a
child interpreter of its own.  The last test needs a card and skips
without one.
"""

import json
import os
import subprocess
import sys

import pytest

from portbench import run

CELLS = ["silesia-id.load", "silesia-id.save", "silesia-seq.load",
         "silesia-seq.save"]
# an object of two chunks, the last partial, and one of stored chunks
TINY = {"objects": [["dickens", 126975], ["x-ray", 61439]]}

CHILD = r"""
import json, sys
import torch
from portbench import control, run

cell, seed, tiny = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
call = run.cell_spec(cell)["traffic"]["call"]
tiny["call"] = call


def fault(kind):
    def wrap(entry):
        def broken(*args, **kwargs):
            out = entry(*args, **kwargs)
            if call == "load":
                out = out.clone()
                if kind == "unchanged":
                    out.zero_()
                elif kind == "half":
                    out[out.numel() // 2:] = 0
                else:
                    out[out.numel() // 3] ^= 1
                return out
            if kind == "unchanged":
                return out[:10]  # the stream identifier, nothing encoded
            if kind == "half":
                return out[: len(out) // 2]
            b = bytearray(out)
            b[len(b) // 3] ^= 1
            return bytes(b)
        return broken
    return wrap


wrappers = {"none": None, "control": control.CONTROLS[call],
            "unchanged": fault("unchanged"), "half": fault("half"),
            "altered": fault("altered")}
out = {}
for name, wrapper in wrappers.items():
    res = run.run_cell(cell, seed, 0.5, False, device="cpu",
                       entry_wrapper=wrapper, traffic=dict(tiny))
    out[name] = {"correct": res["correct"], "checks": res["checks"],
                 "attempted": res["attempted"]}
print(json.dumps(out))
"""


def _child(cell: str, seed: int) -> dict:
    p = subprocess.run([sys.executable, "-c", CHILD, cell, str(seed),
                        json.dumps(TINY)], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=600, env=_cpu_env())
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _cpu_env() -> dict:
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


@pytest.mark.parametrize("cell", CELLS)
def test_without_a_card_the_command_prints_no_result(cell):
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload", cell,
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace",
                        "0"], cwd=run.ROOT, capture_output=True, text=True,
                       timeout=300, env=_cpu_env())
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_controls_and_faults_come_out_false(cell):
    got = _child(cell, 2**31 + 11)
    sound = got.pop("none")
    assert sound["correct"], sound
    for name, res in got.items():
        assert not res["correct"], (name, res)
    if cell.endswith(".load"):
        for where in ("first", "middle", "last"):
            assert got["control"]["checks"][f"corrupt_{where}_accepted"]["value"] == 1
            assert sound["checks"][f"corrupt_{where}_accepted"]["value"] == 0
        assert got["control"]["checks"]["bad_bytes"]["value"] == 0
    else:
        assert got["control"]["checks"]["bad_bytes"]["value"] > 0
    for name in ("unchanged", "half", "altered"):
        assert got[name]["checks"]["bad_bytes"]["value"] > 0


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; from portbench import run; "
            "run.run_cell('silesia-id.load', 3, 0.2, False, device='cpu', "
            "traffic={'call': 'load', 'objects': [['xml', 65536]]}); "
            "print(run.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=_cpu_env())
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cuda_device, cell):
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload", cell,
                        "--seed", str(2**31 + 9), "--seconds", "2", "--trace",
                        "0"], cwd=run.ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
