"""Run one cell of the benchmark of roma_tpu_torch on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell named in BENCHMARK.json (its configuration, traffic mix
and metrics, each a file under perfbench/), warms up, measures for
``--seconds``, checks what the timed path produced against the plain
float32 reference in perfbench/reference/, and prints one JSON object as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, ``breakdown`` (with
``--trace 1``) and, last, ``checks``: each number compared beside its
limit, which also end standard error.

It exits with a non-zero code and prints no result on a machine without
the cards the cell asks for, and if the JAX stack or the JAX package has
been loaded into the process.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["ROMA_TPU_CACHE"] = str(build / "perfbench" / "zoo_cache")
    os.environ["ROMA_TPU_OFFLINE"] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        p.error("--seed must be >= 0 and --seconds > 0")
    _caches()
    sys.path.insert(0, str(ROOT))
    from perfbench.lib import guard, harness, spec

    try:
        cell = spec.load_cell(args.workload)
        guard.require_cards(cell.chips)
    except (spec.SpecError, guard.Refused) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    try:
        guard.require_no_jax()
    except guard.Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    card = harness.power_limit()
    if card:
        print(f"perfbench: card {card}", file=sys.stderr)
    print(f"perfbench: readings {json.dumps(result.pop('readings'), default=str)}", file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
