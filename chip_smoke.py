#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper).

  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``src/repro_torch/csrc`` and print ``ptxas``'s register and
   shared-memory report;
2. K1 (matmul) against its plain PyTorch version on the card: 2048^3 f32,
   the serving ``prefill`` operand ``x.T``, a ragged 2047x1999x1000 f32, and
   1024^3 bf16;
3. K2 (matadd) bit-exact against its plain version: f32, bf16 and int32 at
   2048^2, (512, 384), (64, 128) and a ragged (33, 77);
4. each kernel's time at the main path's 2048 shapes (median over batches
   bracketed by CUDA events) beside its plain version's, one PyTorch call's
   (``torch.matmul`` without TF32, ``torch.add``) and the card's bound;
5. one request chain executed on the card and on the CPU from the same
   inputs, outputs compared;
6. the executed serving arena: the pinned CI stream (12 requests, 6 decode
   chunks, 5 steps, a worker drop at step 2, seed 0) at 2048 x 2048 f32
   blocks on ``cuda:0`` under all five policies.  Launch counters are set
   to 0 just before and read just after: every ``prefill`` must have been a
   matmul launch and every ``decode`` a matadd launch.

The line before the last is a JSON object listing each kernel with its
launches on the main path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# CI serving stream (the verify recipe's pinned arguments) at the main path's
# block side: a 2048 x 2048 f32 block is the 16 MiB each edge is charged
STREAM = dict(n_requests=12, decode_chunks=6, steps=5, drop_step=2, seed=0)
SIDE = 2048

# published peaks of each H100 part (NVIDIA's data sheets, full power limit):
# f32 FLOP/s outside the tensor cores, device memory bytes/s; the first key
# found in torch's device name wins (SXM5 reports "NVIDIA H100 80GB HBM3")
PEAKS = (
    ("H100 PCIe", (51e12, 2.0e12)),
    ("H100 NVL", (60e12, 3.9e12)),
    ("H100", (67e12, 3.35e12)),
)
REPLACES = {
    "matmul": "src/repro/kernels/matmul.py:44",
    "matadd": "src/repro/kernels/matadd.py:28",
}


def bound(flops: float, nbytes: float, peaks: tuple[float, float]) -> tuple[float, str]:
    """-> (least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def mm_tol(k: int, dtype: torch.dtype, scale: float = 1.0) -> dict:
    """bf16: the test suite's 2e-2.  f32: the suite's 2e-4 at K = 128, grown
    linearly with K as the rounding bound of a K-term f32 sum grows (two
    correct kernels may sum in different orders); ``scale`` is the size of
    the values compared (atol is relative to it)."""
    if dtype == torch.bfloat16:
        return dict(rtol=2e-2, atol=2e-2 * scale)
    t = 2e-4 * max(k, 128) / 128
    return dict(rtol=t, atol=t * scale)


def time_ms(fn, batches: int = 7, per_batch: int = 20, queued: bool = True) -> float:
    """Median over batches of the mean time of one call, bracketed by CUDA
    events around each batch of back-to-back calls (after a warm-up).

    ``queued``: the batch is enqueued behind a ~10 ms device sleep, so the
    calls run back to back on the card and the events measure device time
    alone; without it the host's launch rate paces the batch (what a Python
    loop of single launches gets)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(20_000_000)
        t0.record()
        for _ in range(per_batch):
            fn()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1) / per_batch)
    return statistics.median(out)


def check_matmul(matmul, ref, gen) -> float:
    """-> max |error| at the main path's shape (2048^3 f32, B = x.T)."""
    main_err = None
    cases = [
        (2048, 2048, 2048, torch.float32, False),
        (2048, 2048, 2048, torch.float32, True),
        (2047, 1999, 1000, torch.float32, False),
        (1024, 1024, 1024, torch.bfloat16, False),
    ]
    for m, k, n, dt, transposed in cases:
        a = torch.randn(m, k, device="cuda", generator=gen).to(dt)
        if transposed:
            b = torch.randn(n, k, device="cuda", generator=gen).to(dt).T
        else:
            b = torch.randn(k, n, device="cuda", generator=gen).to(dt)
        got = matmul(a, b)
        want = ref.matmul(a, b)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"matmul {m}x{k}x{n}: {got.shape} {got.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        tol = mm_tol(k, dt)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        print(f"[K1] matmul {m}x{k}x{n} {str(dt)[6:]} "
              f"{'B=x.T ' if transposed else ''}max_abs_err={err} "
              f"(rtol=atol={tol['rtol']:.2e}) ok")
        if transposed and m == 2048:
            main_err = err
    return main_err


def check_matadd(matadd, ref, gen) -> float:
    worst = 0.0
    for shape in [(2048, 2048), (512, 384), (64, 128), (33, 77)]:
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            if dt == torch.int32:
                lo, hi = -(2**31), 2**31 - 1
                a = torch.randint(lo, hi, shape, device="cuda", dtype=dt, generator=gen)
                b = torch.randint(lo, hi, shape, device="cuda", dtype=dt, generator=gen)
            else:
                a = torch.randn(shape, device="cuda", generator=gen).to(dt)
                b = torch.randn(shape, device="cuda", generator=gen).to(dt)
            got = matadd(a, b)
            want = ref.matadd(a, b)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"matadd {shape} {dt}: not bit-exact")
            if dt != torch.int32:
                worst = max(worst, (got.float() - want.float()).abs().max().item())
            print(f"[K2] matadd {shape} {str(dt)[6:]} bit-exact ok")
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    peaks = next((v for key, v in PEAKS if key in name), None)
    if peaks is None:
        raise ValueError(f"no published peaks on record for {name!r}; add them to PEAKS")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"f32 peak {peaks[0] / 1e12:g} TFLOP/s, memory {peaks[1] / 1e12:g} TB/s")

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.arena import make_request_stream
    from repro_torch.core.executor import TorchExecutor, attach_request_kernels
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.matadd import matadd
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.serve import request_dag, run_arena_executed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. build
    t_build = time.perf_counter()
    lib = _build.build()
    _build.library()
    t_build = time.perf_counter() - t_build
    print(f"[build] {os.path.relpath(lib, ROOT)} in {t_build:.1f} s")
    for line in _build.last_log.splitlines():
        if line.startswith("==") or "registers" in line:
            print(f"[build] {line.strip()}")

    # 2-3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    mm_err = check_matmul(matmul, ref, gen)
    ma_err = check_matadd(matadd, ref, gen)

    # 4. times at the main path's shapes: prefill = x @ x.T, decode = x + x
    a = torch.randn(SIDE, SIDE, device=dev, generator=gen)
    b = torch.randn(SIDE, SIDE, device=dev, generator=gen)
    bt = b.T
    f32 = a.element_size()
    block = SIDE * SIDE * f32  # each input read once, the output written once
    bounds = {
        "matmul": bound(2.0 * SIDE**3, 3 * block, peaks),
        "matadd": bound(float(SIDE * SIDE), 3 * block, peaks),
    }
    # the timing phase's launches are not the main path's: the counters are
    # reset to 0 right before the arena below
    times = {
        "matmul": (time_ms(lambda: matmul(a, bt)), time_ms(lambda: ref.matmul(a, bt)),
                   time_ms(lambda: torch.matmul(a, bt))),
        "matadd": (time_ms(lambda: matadd(a, b)), time_ms(lambda: ref.matadd(a, b)),
                   time_ms(lambda: torch.add(a, b))),
    }
    paced = {"matmul": time_ms(lambda: matmul(a, bt), queued=False),
             "matadd": time_ms(lambda: matadd(a, b), queued=False)}
    for k, (ms, plain, lib_ms) in times.items():
        print(f"[time] {k} {SIDE}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {bounds[k][0]:.4f} ms ({bounds[k][1]}); "
              f"host-paced kernel {paced[k]:.4f} ms/call; {smi}")

    # 5. one request chain on the card vs the CPU, same host inputs
    g = request_dag(2, 6, prefill_ms_big=1.0, prefill_ms_small=1.0,
                    decode_ms_big=1.0, decode_ms_small=1.0, kv_bytes=SIDE * SIDE * f32)
    inputs = attach_request_kernels(g, SIDE)
    place = {n: "gpu" for n in g.nodes}
    got = TorchExecutor({"gpu": dev}).run(g, place, inputs).outputs
    want = TorchExecutor({"gpu": torch.device("cpu")}).run(g, place, inputs).outputs
    if set(got) != set(want) or not got:
        raise AssertionError(f"exit blocks differ: {sorted(got)} vs {sorted(want)}")
    for n in sorted(got):
        x = got[n].cpu()
        if x.shape != (SIDE, SIDE) or not torch.isfinite(x).all():
            raise AssertionError(f"{n}: shape {tuple(x.shape)} or non-finite values")
        scale = want[n].abs().max().item()
        torch.testing.assert_close(x, want[n], **mm_tol(SIDE, torch.float32, scale))
        err = (x - want[n]).abs().max().item()
        print(f"[chain] {n}: card vs CPU max_abs_err={err} ok")

    # 6. the executed serving arena, counted
    matmul.launches = 0
    matadd.launches = 0
    wall0 = time.perf_counter()
    _, arena = run_arena_executed(
        STREAM["n_requests"], STREAM["decode_chunks"], steps=STREAM["steps"],
        drop_step=STREAM["drop_step"], seed=STREAM["seed"], side=SIDE, device=dev)
    torch.cuda.synchronize()
    arena_wall_ms = (time.perf_counter() - wall0) * 1e3
    launches = {"matmul": matmul.launches, "matadd": matadd.launches}
    by_op = {"prefill": 0, "decode": 0}
    # the same stream's graphs (run_arena_executed's default churn)
    stream_nodes = sum(s.graph.num_nodes() for s in make_request_stream(
        STREAM["steps"], base_requests=STREAM["n_requests"],
        decode_chunks=STREAM["decode_chunks"], seed=STREAM["seed"]))
    for policy, rep in sorted(arena.reports.items()):
        d = rep.to_dict()
        for op in by_op:
            by_op[op] += d["kernels_by_op"].get(op, 0)
        if d["kernels"] < stream_nodes or d["steps"] != STREAM["steps"]:
            raise AssertionError(f"{policy}: incomplete ({d['kernels']} kernels, "
                                 f"{d['steps']} steps; stream has {stream_nodes})")
        if not all(math.isfinite(v) and v > 0 for v in d["mean_kernel_ms"].values()):
            raise AssertionError(f"{policy}: bad kernel times {d['mean_kernel_ms']}")
        print(f"[arena] {policy}: total_makespan_ms={d['total_makespan_ms']:.3f} "
              f"transfers={d['transfers']} bytes={d['bytes_moved']} "
              f"kernels={d['kernels']} mean_kernel_ms="
              + json.dumps({c: round(v, 4) for c, v in sorted(d["mean_kernel_ms"].items())})
              + f" wall_ms={d['wall_ms']:.1f}")
    if min(launches.values()) == 0 or (
            launches["matmul"] != by_op["prefill"] or launches["matadd"] != by_op["decode"]):
        raise AssertionError(f"launches {launches} != executed {by_op}")
    print(f"[arena] launches {launches} == executed prefill/decode {by_op}; {smi}")
    kernel_ms = sum(launches[k] * times[k][0] for k in launches)
    print(f"[arena] wall {arena_wall_ms:.1f} ms for all policies; launches x kernel "
          f"time {kernel_ms:.1f} ms (device busy share ~{kernel_ms / arena_wall_ms:.1%})")

    errs = {"matmul": mm_err, "matadd": ma_err}
    kernels = []
    for k, (ms, plain, lib_ms) in times.items():
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{k}.cu",
            "replaces": REPLACES[k],
            "launches": launches[k],
            "max_abs_err": errs[k],
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1],
            "library_ms": lib_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
