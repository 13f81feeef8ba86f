"""The controls of ``correct``: each puts a path that breaks one of the
configuration's guarantees in the program's place and drives the rest
of a run, whose comparison has to come out false.

    python3 -m portbench.control --workload <name> --seeds <a,b,c> --seconds <s>

- load: the port's own decode with ``verify_checksums=False``, the step
  that would tempt a later PR (it skips the CRC kernel).  The decoded
  bytes stay right; each ``corrupt_*_accepted`` has to read 1.
- save: the reference encoder with a hash table of 2**12 entries in
  place of 2**14, a faster encoder whose streams are valid Snappy but not
  the greedy reference's bytes; ``bad_bytes`` has to read above 0.

The benchmark's own runs never run these.  On a machine without a card
``--device cpu`` runs them at the traffic's sizes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import reference


def _load_control(entry):
    def control(stream, verify_checksums=True, device=None):
        return entry(stream, verify_checksums=False, device=device)
    return control


def _save_control(entry):
    def control(tensor):
        return reference.frame(tensor.cpu().numpy(), table_bits=12)[0]
    return control


CONTROLS = {"load": _load_control, "save": _save_control}


def main(argv=None) -> int:
    from portbench import run

    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    call = run.cell_spec(args.workload)["traffic"]["call"]
    for seed in args.seeds.split(","):
        res = run.run_cell(args.workload, int(seed), args.seconds, False,
                           device=args.device, entry_wrapper=CONTROLS[call])
        print(json.dumps({"workload": args.workload, "seed": int(seed),
                          "correct": res["correct"], "checks": res["checks"],
                          "device": res["device"]["kind"]}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
