"""Serving scenario on the PyTorch port (the twin of
``examples/heterogeneous_serving.py``): place batched request DAGs on a
heterogeneous pair of pods (big + small over DCN) with each scheduling
policy, then run a REAL reduced-model decode to show the serving loop
itself (granite-3-2b's reduced config in f32: the CUDA flash-attention
kernel in its prefill, one CUDA graph a decode step; the plain versions
with ``--device cpu``).

Run:  PYTHONPATH=src python examples/heterogeneous_serving_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu, where the kernels' plain versions run")
    args = ap.parse_args(argv)
    serve_main(["--arch", "granite_3_2b", "--smoke", "--requests", "6",
                "--prompt-len", "24", "--decode-len", "12", "--scheduler", "gp",
                "--device", args.device])
    for pol in ("eager", "dmda", "heft"):
        serve_main(["--requests", "6", "--scheduler", pol])


if __name__ == "__main__":
    main()
