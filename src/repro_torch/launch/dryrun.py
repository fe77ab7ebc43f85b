"""Multi-pod dry run (the port of ``repro/launch/dryrun.py``): trace every
(architecture x input shape x mesh) cell's step on the production meshes
and record the FLOP, memory and collective counts the roofline reads.

It runs as its own process: it starts a ``fake`` process group the size of
the production mesh (256 ranks, or 512 with ``--multi-pod``), in which this
one process is rank 0 and every collective returns at once, and traces
rank 0's real train, prefill or decode step
(:mod:`repro_torch.launch.steps`) on ``meta`` tensors: its blocks of the
parameters and optimizer state (``eval_specs``), of the batch
(``input_specs``) and of the caches (``cache_specs``).  Nothing is computed
or allocated and no GPU is needed.  The counts are rank 0's own
(:mod:`repro_torch.launch.flops`, :mod:`repro_torch.launch.hlo`), so
nothing is divided by the number of chips.

Each cell's record keeps the reference's keys where they mean something
here: ``status`` and ``reason``; ``n_chips``; ``flops_per_device`` and
``bytes_per_device`` (the fusion-optimistic memory traffic);
``collectives`` (with ``per_axis``, the wire bytes over each mesh axis);
``peak_live_bytes_analytic`` and ``fits_hbm_analytic`` (against one H100's
memory); ``model_flops_per_device`` and ``useful_flops_ratio``; ``terms``
(compute, memory and collective seconds at one H100's peak rates, the
collectives over each axis at its link's rate,
:data:`repro_torch.launch.mesh.LINK_BW`), ``dominant`` and
``roofline_fraction``; ``bytes_hlo_walk``, every op's inputs and outputs
unfused (the twin of the reference's walk of the HLO); and ``t_lower_s``,
the trace's time.  It drops ``t_compile_s`` and ``mem`` (nothing is
compiled) and the ``*_hlo_naive`` keys (there is no HLO).  These are
analytic counts, not times.

Of the reference's flags it drops ``--q-chunk`` and ``--kv-chunk``: they
pick between attention branches that compute the same function, and the
port sends both to one K3 call, so they would change nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from ..configs.base import SHAPES, pad_for_tp, shape_applicable
from ..configs.registry import ARCH_IDS, canon, get_config, input_specs
from ..models.moe import padded_experts
from ..models.params import eval_specs
from ..models.transformer import model_param_specs
from ..parallel import sharding as shd
from . import flops as flops_mod
from . import hlo as hlo_mod
from .mesh import HBM_BW, HBM_PER_CHIP, LINK_BW, PEAK_FLOPS_BF16, make_production_mesh
from .steps import (DistConfig, make_decode_step, make_prefill_step, make_train_step,
                    replicated, shardings_for_batch)

_MESHES: dict = {}


def fake_world(size: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``size`` ranks
    (the one already started where it has that size)."""
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
        _MESHES.clear()
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def production_mesh(multi_pod: bool):
    """The production mesh over a fake process group of its size."""
    if multi_pod not in _MESHES:
        fake_world(512 if multi_pod else 256)
        _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod)
    return _MESHES[multi_pod]


def _pdt(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.param_dtype]


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool, dist: DistConfig = DistConfig(),
               cfg_overrides=None) -> dict:
    """Trace one cell's step on rank 0 of the production mesh; returns its
    record."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "status": "skip",
                "reason": reason}
    mesh = production_mesh(multi_pod)
    t0 = time.time()
    if shape.kind == "train":
        step, p_specs, o_specs, ctx = make_train_step(cfg, mesh, dist)
        batch = input_specs(cfg, shape)
        whole = (eval_specs(p_specs, _pdt(cfg)), eval_specs(o_specs), batch)
        shardings = (shd.tree_shardings(p_specs, mesh, ctx.rules),
                     shd.tree_shardings(o_specs, mesh, ctx.rules),
                     shardings_for_batch(batch, mesh, ctx.rules))
    elif shape.kind == "prefill":
        step, p_specs, ctx = make_prefill_step(cfg, mesh, dist)
        batch = input_specs(cfg, shape)
        whole = (eval_specs(p_specs, _pdt(cfg)), batch)
        shardings = (shd.tree_shardings(p_specs, mesh, ctx.rules),
                     shardings_for_batch(batch, mesh, ctx.rules))
    else:
        step, p_specs, c_specs, ctx = make_decode_step(
            cfg, mesh, dist, batch=shape.global_batch, cache_len=shape.seq_len)
        whole = (eval_specs(p_specs, _pdt(cfg)), eval_specs(c_specs),
                 torch.empty(shape.global_batch, dtype=torch.int32, device="meta"),
                 torch.zeros((), dtype=torch.long, device="meta"))
        tok_spec = shd.spec_for(("batch",), ctx.rules, mesh, (shape.global_batch,))
        shardings = (shd.tree_shardings(p_specs, mesh, ctx.rules),
                     shd.tree_shardings(c_specs, mesh, ctx.rules),
                     shd.NamedSharding(mesh, tok_spec), replicated(mesh))
    # rank 0's blocks
    args = tuple(shd.shard_tree(a, sh) for a, sh in zip(whole, shardings))
    del whole
    with torch.no_grad() if shape.kind != "train" else torch.enable_grad():
        _, trace = flops_mod.trace_step(step, *args)
    t_lower = time.time() - t0
    del args

    stats = hlo_mod.analyze(trace, mesh)
    coll = stats["collectives"]
    flops = trace.flops
    mem_traffic = trace.mem_bytes
    peak_live = trace.peak
    n_chips = mesh.size
    mf = model_flops(cfg, shape, tp=mesh.shape.get("model", 1))
    rec = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "n_chips": n_chips,
        "accounting": "ring-wire-v2",
        "t_lower_s": round(t_lower, 1),
        "flops_per_device": flops,
        "bytes_per_device": mem_traffic,
        "bytes_hlo_walk": stats["mem_bytes"],
        "collectives": coll,
        "peak_live_bytes_analytic": int(peak_live),
        "fits_hbm_analytic": bool(peak_live <= HBM_PER_CHIP),
        "model_flops_per_device": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / flops if flops else 0.0,
        "op_count": sum(trace.op_counts.values()),
    }
    rec["terms"] = {
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": mem_traffic / HBM_BW,
        "collective_s": sum(b / LINK_BW[a] for a, b in coll["per_axis"].items()),
    }
    rec["dominant"] = max(rec["terms"], key=rec["terms"].get)
    bound = max(rec["terms"].values())
    rec["roofline_fraction"] = rec["terms"]["compute_s"] / bound if bound else 0.0
    return rec


def model_flops(cfg, shape, tp: int = 1) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference) with N = active
    non-embedding params (MoE: routed experts scaled by top_k/E)."""
    cfg = pad_for_tp(cfg, tp)
    total = 0
    expert = 0

    def walk(tree, keys):
        nonlocal total, expert
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, keys + (k,))
            return
        if "embed" in keys or "unembed" in keys:
            return
        n = math.prod(tree.shape)
        total += n
        if keys[-1] in ("w_gate", "w_up", "w_down"):
            expert += n

    walk(model_param_specs(cfg, tp=tp), ())
    if expert and cfg.n_experts:
        active = expert * (cfg.top_k / padded_experts(cfg.n_experts, tp))
        total = total - expert + active
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * total * tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--mode", type=str, default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--param-dtype", type=str, default=None)
    ap.add_argument("--moe-dedup", action="store_true")
    ap.add_argument("--moe-dest-k", type=float, default=None)
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--no-decode-seqpar", action="store_true")
    ap.add_argument("--out", type=str, default="artifacts/dryrun")
    args = ap.parse_args(argv)

    dist_cfg = DistConfig(
        seq_parallel=args.seq_parallel,
        sharding_mode=args.mode,
        decode_seqpar=not args.no_decode_seqpar,
        moe_dedup=args.moe_dedup,
        moe_dest_k=args.moe_dest_k,
    )
    archs = ARCH_IDS if (args.all or not args.arch) else [canon(args.arch)]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}.{shape}.{'multipod' if mp else 'pod'}"
                if args.mode != "tp":
                    tag += f".{args.mode}"
                if args.tag:
                    tag += f".{args.tag}"
                ov = {"param_dtype": args.param_dtype} if args.param_dtype else None
                try:
                    rec = lower_cell(arch, shape, multi_pod=mp, dist=dist_cfg, cfg_overrides=ov)
                except Exception as e:  # a failure here is a bug in the system
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp, "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    failures += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    t = rec["terms"]
                    extra = (f" compute={t['compute_s'] * 1e3:.2f}ms "
                             f"mem={t['memory_s'] * 1e3:.2f}ms "
                             f"coll={t['collective_s'] * 1e3:.2f}ms "
                             f"dom={rec['dominant']} fits={rec['fits_hbm_analytic']}"
                             f" trace={rec['t_lower_s']}s")
                elif status == "fail":
                    extra = " " + rec["error"][:160]
                print(f"[dryrun] {tag:55s} {status}{extra}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"[dryrun] {failures} FAILURES", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
