"""The control of a cell's check: the plain reference put in the program's
place, computed in the nearest precision below the one the configuration
states, read exactly as a run reads the program.

* bf16 training cells: "fp8": wherever the program rounds to bf16 (every
  operand of every matrix product: the dense layers, the attention
  products, the convolutions, the tied head; every dense layer's and
  LayerNorm's output) the reference rounds to float8 e4m3 with one scale a
  tensor (its largest magnitude to 448), a straight-through rounding: the
  backward's products take the rounded operands, the gradient passes the
  rounding unchanged,
* the f32 serving cell: "tf32": the reference with TF32 allowed in cuBLAS
  and cuDNN.

Run on the card at a cell's own size, on seeds of its own:

    python3 -m port_bench.reference.control --workload finetune.cached --seeds 1 2 3
    python3 -m port_bench.reference.control --workload finetune.cached --seeds 1 2 3 \
        --fault half_batch

(`--fault`: a training cell's fault planted in the f32 reference put in
the program's place, read against the clean reference.)

prints one JSON line a seed: the control's numbers beside the cell's limits.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Straight-through e4m3 rounding with one scale for the tensor."""
    scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t.detach())


def control_numbers(files, cell: str, seed: int, device, fault: str = None) -> dict:
    """The control's numbers, or with `fault` (a training cell's) those of
    the f32 reference with that fault planted, against the reference."""
    from port_bench.lib import bench, check

    workload = files.json("workloads", cell)
    config = files.json("configs", workload["config"])
    ctx = bench.Ctx(cell, workload, config, seed, 0.0, False, device, 0.0)
    entry = files.module("entries", workload["entry"])
    kind = fault or workload["control"]
    if fault is not None or kind == "fp8":
        r = entry.control(ctx, None if fault else fp8, fault)
        numbers, _ = check.training_numbers(r["control"], r["reference"])
    else:
        numbers = entry.control(ctx, kind)
    return {"workload": cell, "seed": seed, "control": kind,
            "check": {n: {"value": v, "limit": workload["check"].get(n)}
                      for n, v in numbers.items()}}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None,
                   help="instead of the control: a fault planted in the f32 reference "
                        "(unchanged_state, half_batch, altered_answer)")
    args = p.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.dirname(here))
    from port_bench.lib import bench

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(control_numbers(bench.Files(here), args.workload, seed,
                                         torch.device("cuda", 0), args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
