"""Readings for the correctness limits of a cell, on the card, in one
process: the program on a dozen seeds or more, the lower-precision control
in its place, and planted faults, each with a short window at the cell's
own sizes. One JSON line a run: what ran, its seed, its checks (value and
limit) and its end-to-end metrics.

    python3 perfbench/calibrate.py --workload match560_single --seeds 11,12,13 \\
        --control_seeds 21,22,23 --faults shifted_warp --seconds 8 --out calib.jsonl
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def calibrate(workload: str, seeds, control_seeds, faults, seconds: float, out=None, device="cuda",
              cell=None, fault_seeds=None) -> list[dict]:
    """Run the program on ``seeds``, the control on ``control_seeds`` and
    each fault of ``faults`` on ``fault_seeds`` (``control_seeds`` by
    default); returns (and appends to ``out``) one record a run."""
    from perfbench.lib import harness, spec

    cell = cell or spec.load_cell(workload)
    plan = ([("program", s, None, False) for s in seeds] + [("control", s, None, True) for s in control_seeds]
            + [(f, s, f, False) for f in faults for s in (control_seeds if fault_seeds is None else fault_seeds)])
    rows = []
    for kind, seed, fault, control in plan:
        t = time.perf_counter()
        try:
            r = harness.run_cell(cell, seed, seconds, False, t, device=device, fault=fault, control=control)
        except Exception as e:  # one failed run is a reading too; the next seeds still run
            import traceback

            row = {"workload": cell.name, "kind": kind, "seed": seed, "error": traceback.format_exc()[-3000:]}
            print(repr(e), file=sys.stderr, flush=True)
            rows.append(row)
            if out is not None:
                with open(out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            continue
        row = {"workload": cell.name, "kind": kind, "seed": seed, "correct": r["correct"], "checks": r["checks"],
               "readings": r.get("readings", {}), "metrics": {k: v["value"] for k, v in r["metrics"].items()},
               "run_s": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out is not None:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault_seeds", default=None, help="the faults' seeds (default: the control's)")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    sys.path.insert(0, str(ROOT))
    from perfbench.run import _caches

    _caches()
    from perfbench.lib import guard

    guard.require_cards(1)
    calibrate(a.workload, ints(a.seeds), ints(a.control_seeds), [f for f in a.faults.split(",") if f], a.seconds,
              a.out, fault_seeds=None if a.fault_seeds is None else ints(a.fault_seeds))


if __name__ == "__main__":
    main()
