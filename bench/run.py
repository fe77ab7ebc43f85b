"""Run one cell of the benchmark of the PyTorch port and print its result.

    python3 bench/run.py --workload granite-3-2b.decode --seed 7 --seconds 30 --trace 0

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
output check compared, beside its limit); the checks are also the last
lines of standard error.  Without a CUDA device, or with fewer than the
cell asks for, it prints no result and exits 3; if ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` was loaded, it exits 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    harness.set_cache_dirs()
    try:
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.NoDevice as e:
        print(f"bench: {e}", file=sys.stderr)
        return 3
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
