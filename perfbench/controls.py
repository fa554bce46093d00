#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process: the
cell run on each seed with the control put in the program's place for
the check (the reference in a lower precision, ``bf16`` or ``fp8``, or
with half of each batch, ``half_batch``), so that each line has to read
not correct.  Each line also holds the program's own numbers under
``program``.

    python3 perfbench/controls.py --workload <name> --control <bf16|fp8|half_batch> \\
        --seconds <s> --seeds <n> [<n> ...]

Prints each run's result line, then one JSON line per compared number:
the program's largest reading and the control's smallest, and last
``{"control_correct": [...]}``, each run's ``correct``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    from perfbench.harness import execute, set_cache_dirs
    set_cache_dirs()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    prog, ctrl, verdicts = {}, {}, []
    for seed in args.seeds:
        buf = io.StringIO()
        rc = execute(args.workload, seed, args.seconds, False, t_start=time.perf_counter(),
                     control=args.control, out=buf)
        line = buf.getvalue().strip().splitlines()[-1] if buf.getvalue().strip() else "{}"
        print(f"seed {seed} rc {rc} {line}", flush=True)
        res = json.loads(line)
        verdicts.append(res.get("correct"))
        for k, v in res.get("checks", {}).items():
            ctrl.setdefault(k, []).append(v["value"])
            prog.setdefault(k, []).append(res["program"][k])
    for k in prog:
        print(json.dumps({"number": k, "program_max": max(prog[k]), "program": prog[k],
                          "control_min": min(ctrl.get(k, [float("nan")])),
                          "control": ctrl.get(k, [])}), flush=True)
    print(json.dumps({"control_correct": verdicts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
