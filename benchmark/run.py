"""Run one cell of the port's benchmark on the card this process finds.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit. The same numbers close standard error.

Exits non-zero with no result where there is no CUDA device (or fewer than
the cell asks for): a run never falls back to the CPU. Kernel builds go to
``build/`` inside the checkout (the program's own rule), so only a cell's
first run in a checkout compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "sonar_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``sonar_tpu_torch`` is not ``sonar_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    bench = harness.load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"run.py: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = harness.run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda", t_start=T_START,
                              bench=bench, log=log)
    found = forbidden_modules()
    if found:
        log(f"run.py: the run loaded {found}: the benchmark measures sonar_tpu_torch alone")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
