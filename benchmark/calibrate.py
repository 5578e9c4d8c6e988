"""The readings a cell's limit is set from, and the proof that the check
fails what it must, at the cell's own size (not part of a benchmark run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... [--faults none,control,...] [--limit file|none]

For each fault of ``--faults`` (``none`` is the program as it is; the
others are ``faults.NAMES``) and each seed, one run of the cell
(``harness.run_cell`` with ``seconds=0``: set-up, a warm-up call, the calls
the check takes, the check) with the fault planted: its ``latent_gap``
against the float32 reference and, under the cell's limit file
(``--limit file``) or none (``--limit none``), whether it came out
``correct``. Prints one JSON line a run, then one a fault: the largest and
smallest gap. The lower reading of a limit is the largest over the
program's seeds, the upper the smallest over the control's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="none")
    ap.add_argument("--limit", choices=("file", "none"), default="none")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import faults, harness
    from benchmark import traffic as T

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config, traffic = T.load("configs", cell["config"]), T.load("traffic", cell["traffic"])
    limits = None if args.limit == "file" else {"latent_gap": {"limit": float("inf")}}
    seeds = [int(s) for s in args.seeds.split(",")]
    for fault in args.faults.split(","):
        planted = None if fault == "none" else fault
        if planted and not faults.applies(planted, traffic):
            continue
        gaps = []
        for seed in seeds:
            t0 = time.perf_counter()
            with faults.planted(planted, config, traffic):
                r = harness.run_cell(args.workload, seed=seed, seconds=0.0, trace=False,
                                     device="cuda", t_start=t0, bench=bench, limits=limits,
                                     log=lambda m: print(m, file=sys.stderr))
            c = r["checks"]["latent_gap"]
            gaps.append(c["value"])
            print(json.dumps({"fault": fault, "seed": seed, "latent_gap": c["value"],
                              "limit": c["limit"], "correct": r["correct"],
                              "s": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "fault": fault,
                          "card": torch.cuda.get_device_name(), "largest": max(gaps),
                          "smallest": min(gaps), "seeds": len(gaps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
