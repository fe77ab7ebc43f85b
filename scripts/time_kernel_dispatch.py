"""Times what the ``torch.library`` custom ops in front of K3, K3b, K4 and K4b
(``repro_torch.kernels.ops``) cost on the host.  Two ways of reaching the
same kernels are alternated in one process:

* ``custom``: every call through its ``torch.ops.repro_torch.*`` op (the
  serving calls and the autograd Functions given the ops);
* ``direct``: the port's path on CUDA tensors, the kernel wrappers called
  with no dispatcher between (the ops serve ``meta`` tensors only).

It times lm-100m's training step (``examples/train_lm_torch.py``'s config,
4 x 128, no remat: one K3 and one K3b call a layer and step) by the host
clock, each step ended by a synchronise, in ``--rounds`` rounds of
``--steps`` steps a way after a warm-up; and one K3 serving call and one K4
call at small shapes, ``--calls`` calls a way, whose host time a call is
launch-bound, so the gap between the ways is the dispatch's cost a call.

    python3 scripts/time_kernel_dispatch.py [--rounds 5] [--steps 20] [--calls 2000]

Each line is prefixed ``[dispatch]`` and ends with the card's name and power
limit.  Needs a CUDA device unless ``--device cpu`` (the plain versions).
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, os.path.join(ROOT, "examples"))

# the attribute of repro_torch.kernels.ops that calls each custom op's kernel
OPS = {"_k3": "flash_attention", "_k3_lse": "flash_attention_fwd",
       "_k3b": "flash_attention_bwd", "_k4": "wkv6", "_k4b": "wkv6_bwd"}


def _ways(ops):
    """{way: {attribute of ops: callable}} for the two ways."""
    import torch

    return {"custom": {a: getattr(torch.ops.repro_torch, op) for a, op in OPS.items()},
            "direct": {a: getattr(ops, a) for a in OPS}}


def _use(ops, way: dict) -> None:
    for name, fn in way.items():
        setattr(ops, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import DistConfig, make_train_step
    from repro_torch.models.params import init_params
    from train_lm_torch import CFG

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("time_kernel_dispatch needs a CUDA device (or --device cpu)")
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip() if cuda else "cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ways = _ways(ops)
    if cuda:
        ops.ensure_warm(dev)

    # one call each way, launch-bound: K3 serving (1 x 1 head x 64, hd 64) and K4
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, 1, 64, 64, generator=gen, device=dev)
    r, k, v = (torch.randn(1, 1, 64, 64, generator=gen, device=dev) * 0.1 for _ in range(3))
    w = torch.rand(1, 1, 64, 64, generator=gen, device=dev) * 0.5 + 0.4
    u = torch.randn(1, 64, generator=gen, device=dev) * 0.1
    calls = {"K3": lambda: ops.flash_attention(q, q, q, causal=True),
             "K4": lambda: ops.wkv6(r, k, v, w, u)}
    per_call = {name: {way: [] for way in ways} for name in calls}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            for way, fns in ways.items():
                _use(ops, fns)
                fn()
                sync()
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    fn()
                sync()
                per_call[name][way].append((time.perf_counter() - t0) / args.calls * 1e6)
    for name, by_way in per_call.items():
        med = {way: statistics.median(us) for way, us in by_way.items()}
        print(f"[dispatch] {name} call: custom {med['custom']:.2f} us, direct "
              f"{med['direct']:.2f} us a call on the host clock (medians of {args.rounds} "
              f"rounds of {args.calls}; custom {by_way['custom']}, direct {by_way['direct']}); "
              f"custom - direct {med['custom'] - med['direct']:.2f} us; {smi}", flush=True)

    # lm-100m's training step, the ways alternated round by round
    step, p_specs, o_specs, _ = make_train_step(CFG, None, DistConfig(remat=False))
    params = init_params(p_specs, torch.Generator(device=dev).manual_seed(0))
    opt = init_params(o_specs, torch.Generator(device=dev).manual_seed(0))
    it = batches(DataConfig(seq_len=128, global_batch=4, vocab=CFG.vocab), dev)
    steps = {way: [] for way in ways}
    try:
        for way, fns in ways.items():            # warm-up, both ways
            _use(ops, fns)
            for _ in range(3):
                step(params, opt, next(it))
        for i in range(args.rounds):
            for way in (("custom", "direct") if i % 2 == 0 else ("direct", "custom")):
                _use(ops, ways[way])
                for _ in range(args.steps):
                    sync()
                    t0 = time.perf_counter()
                    step(params, opt, next(it))
                    sync()
                    steps[way].append((time.perf_counter() - t0) * 1e3)
    finally:
        it.close()
        _use(ops, ways["direct"])
    med = {way: statistics.median(ms) for way, ms in steps.items()}
    rounds = {way: [round(statistics.median(ms[i * args.steps:(i + 1) * args.steps]), 3)
                    for i in range(args.rounds)] for way, ms in steps.items()}
    print(f"[dispatch] lm-100m step (4 x 128, no remat, {2 * CFG.n_layers} K3 and K3b calls "
          f"a step): custom {med['custom']:.3f} ms, direct {med['direct']:.3f} ms (medians of "
          f"{args.rounds * args.steps} steps; round medians custom {rounds['custom']}, direct "
          f"{rounds['direct']}); custom - direct {med['custom'] - med['direct']:.3f} ms; {smi}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
