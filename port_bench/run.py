"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints the numbers compared for `correct`
on standard error, then one JSON object as the last line of standard
output.  Exits with a non-zero code, and prints no result, without CUDA,
with fewer cards than the cell asks for, or when JAX or the JAX package
was loaded into the process.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    # the program's caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(HERE, "_cache", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(HERE, "_cache", "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, CHECKOUT)

    import torch
    from port_bench.lib import bench

    files = bench.Files(HERE)
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        benchmark = json.load(f)
    chips = files.json("workloads", args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = bench.run_cell(files, benchmark, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0), STARTED)
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    for k, v in result["notes"].items():
        print(f"{k}: {json.dumps(v)}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(bench.result_line(result, bool(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
