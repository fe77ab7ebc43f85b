"""Quickstart on the PyTorch port (the twin of ``examples/quickstart.py``):
the paper's pipeline end to end.

1. Express a data-flow task graph (the paper's 38-kernel DAG).
2. Weight it with measured/analytic per-class costs (Formula 1/2 ratios).
3. Partition it (the METIS role) and compare against queue schedulers.
4. Execute the winning placement for real through the port's executor:
   each matmul is one launch of the CUDA matmul kernel on the card (its
   plain PyTorch version with ``--device cpu``).  Both groups run on the
   one device, as the reference's do.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.cost import paper_calibrated_model, workload_ratios
from repro_torch.core.dot import to_dot
from repro_torch.core.executor import TorchExecutor, attach_matrix_kernels
from repro_torch.core.graph import generate_paper_dag
from repro_torch.core.schedulers import make_policy
from repro_torch.core.simulate import make_cpu_gpu_platform, simulate
from repro_torch.launch.serve import default_device

DOT_PATH = os.path.join(tempfile.gettempdir(), "quickstart_torch_partition.dot")


def main(argv=None):
    """Steps 1-4; returns step 4's ``ExecResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu, where the kernels' plain versions run")
    args = ap.parse_args(argv)
    dev = default_device(None if args.device == "cuda" else "cpu")

    # 1. the task graph: 38 two-input matrix kernels, 75 dependencies
    g = generate_paper_dag("matmul")

    # 2. node weights per processor class + edge transfer costs (ms)
    model = paper_calibrated_model()
    g = model.weight_graph(g, {"matmul": 1024})
    ratios = workload_ratios(g, ["cpu", "gpu"])
    print(f"Formula (1)/(2) targets: R_cpu={ratios['cpu']:.3f} "
          f"R_gpu={ratios['gpu']:.3f}")

    # 3. schedule: graph partition vs the queue-based baselines
    plat = make_cpu_gpu_platform()          # 3 CPU workers + 1 GPU over PCIe
    for name in ("eager", "dmda", "gp"):
        pol = make_policy(name)
        r = simulate(g, pol, plat)
        print(f"{name:6s} makespan={r.makespan_ms:8.2f} ms  "
              f"transfers={r.n_transfers:3d}  placement={dict(r.kernels_per_class)}")

    # visualize the partition (open with graphviz: dot -Tpng quickstart.dot)
    gp = make_policy("gp")
    simulate(g, gp, plat)
    with open(DOT_PATH, "w") as f:
        f.write(to_dot(g, {k: (0 if v == "cpu" else 1) for k, v in gp.assignment.items()}))
    print(f"partition visualization -> {DOT_PATH}")

    # 4. run the placement for real (both groups on the one device)
    inputs = attach_matrix_kernels(g, 256)
    ex = TorchExecutor({"cpu": dev, "gpu": dev})
    res = ex.run(g, gp.assignment, inputs)
    print(f"real execution: {res.makespan_ms:.1f} ms, "
          f"{res.n_transfers} inter-group transfers")
    return res


if __name__ == "__main__":
    main()
