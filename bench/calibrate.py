"""The readings a cell's output limits are set from, on the card.

    python3 bench/calibrate.py --workload granite-3-2b.decode --seeds 1-12 \
        --out chiprun_out/calibrate.jsonl
    python3 bench/calibrate.py --workload granite-3-2b.train --seeds 1-3 --variant half_batch

For each seed, in one process: the cell's weights drawn from it, its shapes
warmed, one batch of its traffic served (as many requests sampled as a
run samples), then two readings over the same prompts and served tokens:

- ``program``: the widest gap by which a served token's logit lies below
  the float32 reference's best (what a run's check compares);
- ``control``: the same gap of the tokens the reference computed in fp8
  (``reference.model``'s ``precision="fp8"``) puts first: the reading of
  a program that served one precision below the configuration's bf16.

The limit lies between the largest program reading and the smallest
control reading (``bench/limits/<cell>.json`` gives both and the seeds).

With ``--variant`` naming a serving fault of ``faults.py``, the program
reading is taken with that fault planted (``--no-control`` then skips the
control, which does not depend on it).

For a training cell each seed gives the check's numbers
(``first_grad_gap``, ``change_gap``, ``grad_norm_gap``; and ``loss_gap``,
read but not compared) of the program as it is configured, of the control (the program's own bf16 path for weights and optimizer state),
or of the program with a fault of ``faults.py`` planted.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import harness  # noqa: E402


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def reading(cell, seed: int, device, seconds: float = 0.0, control: bool = True,
            variant: str = "program") -> dict:
    """One seed's program reading (with a fault of ``faults.SERVING``
    planted where ``variant`` names one) and, with ``control``, its control
    reading, over a window of ``seconds`` (at least one batch: as many
    batches as a run needs to sample its ``sample_requests``)."""
    import contextlib

    from bench import faults
    from bench.reference import model as ref

    plant = faults.SERVING[variant]() if variant in faults.SERVING else (
        contextlib.nullcontext())
    mix = cell.traffic
    t0 = time.perf_counter()
    with plant:
        rec, params = harness.run_serving(cell, seed, seconds, False, device, t0,
                                          min_batches=-(-mix["sample_requests"] // mix["batch"]))
    t1 = time.perf_counter()
    checks, _ = harness.check_serving(rec, params, seed)
    t2 = time.perf_counter()
    row = {"seed": seed, "variant": variant, "program": checks["logit_gap"][0],
           "setup_s": rec.setup_s,
           "requests": min(cell.traffic["sample_requests"], rec.attempted),
           "check_s": t2 - t1}
    if control:
        gaps = ref.served_gaps(params, cell.model, *harness.sample(rec, seed), "fp8",
                               control=True)
        row.update(control=gaps.max().item(), control_s=time.perf_counter() - t2)
    return row


def reading_train(cell, seed: int, device, variant: str = "program") -> dict:
    """One seed's numbers of a training cell: of the program
    (``program``), of the program's own bf16 path for the weights and the
    optimizer state (``control``, one precision below the configuration's
    float32), or of the program with a fault of ``faults.TRAINING``."""
    import contextlib

    import torch

    from bench import faults

    plant = faults.TRAINING[variant]() if variant in faults.TRAINING else (
        contextlib.nullcontext())
    dtype = torch.bfloat16 if variant == "control" else torch.float32
    t0 = time.perf_counter()
    with plant:
        rec, made = harness.run_training(cell, seed, 0.0, False, device, t0, dtype=dtype)
    t1 = time.perf_counter()
    checks, _ = harness.check_training(rec, made, seed)
    row = {"seed": seed, "variant": variant, **{k: v for k, (v, _) in checks.items()},
           "loss_gap": rec.first["loss_gap"],
           "loss": rec.first["loss"], "grad_norm": rec.first["grad_norm"],
           "reference": rec.first["reference"], "setup_s": rec.setup_s,
           "check_s": time.perf_counter() - t1}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,7")
    ap.add_argument("--variant", default="program",
                    help="program; training: control, update_skipped or half_batch; "
                         "serving: token_altered or cache_unwritten")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="serving: the window a seed serves (at least one batch)")
    ap.add_argument("--no-control", action="store_true", help="serving: the program only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    harness.require_cuda(1)
    cell = harness.find_cell(args.workload)
    train = cell.traffic["kind"] == "train"
    rows = []
    for s in seeds(args.seeds):
        row = (reading_train(cell, s, "cuda:0", args.variant) if train
               else reading(cell, s, "cuda:0", seconds=args.seconds,
                            control=not args.no_control, variant=args.variant))
        rows.append(row)
        print(json.dumps(row), flush=True)
    nums = [k for k in rows[0] if k.endswith("_gap") or k in ("program", "control")]
    summary = {"workload": args.workload, "variant": args.variant,
               **{f"{k}_max": max(r[k] for r in rows) for k in nums},
               **{f"{k}_min": min(r[k] for r in rows) for k in nums},
               "card": harness.power_limit()}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(dict(r, workload=args.workload)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
