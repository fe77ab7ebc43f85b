"""End-to-end trainer: config -> mesh -> sharded train loop with
checkpoint/restart, failure injection and heartbeat monitoring (the port of
``repro/launch/train.py``).

``train(cfg, mesh, ...)`` runs on the mesh it is given, each process one
rank holding its blocks (:func:`repro_torch.launch.steps.make_train_step`);
``main`` builds the host mesh (one process, every collective the
identity), or with ``--production-mesh`` the reference's (data 16, model
16) mesh, which needs a process group of 256 ranks.  The loop runs on the
card unless the CPU is asked for: attention's forward is the CUDA flash
attention (K3, writing its log-sum-exp rows) and its backward the CUDA
flash-attention backward (K3b); RWKV-6's recurrence is the CUDA WKV6 kernel
(K4) and its backward the CUDA WKV6 backward (K4b), so ``--arch rwkv6_3b``
trains on the card as the attention models do; on the CPU their plain
versions run.

  # the reduced config, f32 activations, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b --smoke \\
      --steps 50 --batch 8 --seq 128 --device cpu

  # on the card, with a checkpoint every 25 steps (a rerun resumes from it)
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b --smoke \\
      --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 25

  # RWKV-6 on the card (K4 forward, K4b backward), sequence parallel
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_3b --smoke --steps 4 \\
      --seq-parallel
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs.registry import canon, get_config
from ..data.pipeline import DataConfig, batches
from ..ft.elastic import Heartbeat, HeartbeatMonitor
from ..models.params import count_params, init_params
from ..parallel.sharding import shard_tree, tree_shardings
from .mesh import make_host_mesh, make_production_mesh
from .serve import _cli_device, default_device
from .steps import DistConfig, make_train_step, shardings_for_batch


def train(
    cfg,
    mesh,
    *,
    steps: int,
    global_batch: int,
    seq_len: int,
    dist: DistConfig = DistConfig(),
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    seed: int = 0,
    fail_at: int | None = None,
    device=None,
):
    """Train ``steps`` steps on ``mesh`` (resuming from ``ckpt_dir``'s latest
    checkpoint when it has one) on synthetic data drawn from ``seed``.
    Returns (params, opt_state, losses): this rank's blocks, and the losses
    logged every ``log_every`` steps and at the last.  ``fail_at`` raises
    before that step runs.  Every rank draws the whole initial tree from
    ``seed`` and keeps its blocks, so the weights do not depend on the
    mesh.  ``device`` defaults to ``cuda:0`` and raises without CUDA: the
    CPU is asked for (``device="cpu"``), never fallen back to."""
    device = default_device(device)
    step_fn, p_specs, o_specs, ctx = make_train_step(cfg, mesh, dist)
    p_sh = tree_shardings(p_specs, mesh, ctx.rules)
    o_sh = tree_shardings(o_specs, mesh, ctx.rules)
    dummy = {"tokens": torch.empty(global_batch, seq_len), "labels": torch.empty(global_batch,
                                                                                 seq_len)}
    b_sh = shardings_for_batch(dummy, mesh, ctx.rules)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    params = opt_state = None
    if mgr is not None:
        got, state = mgr.restore(device=device, shardings={"params": p_sh, "opt": o_sh})
        if got is not None:
            start, params, opt_state = got, state["params"], state["opt"]
            print(f"[train] restored step {start} from {ckpt_dir}")
    if params is None:
        params = shard_tree(init_params(p_specs, torch.Generator(device=device).manual_seed(seed)),
                            p_sh)
        opt_state = shard_tree(init_params(o_specs, torch.Generator(device=device).manual_seed(0)),
                               o_sh)
    where = (f"1 device ({device})" if mesh.size == 1
             else f"{mesh.size} ranks of a {mesh.shape} mesh ({device})")
    print(f"[train] {cfg.name}: {count_params(p_specs) / 1e6:.1f}M params, {where}, "
          f"batch {global_batch} x {seq_len}")

    data_cfg = DataConfig(seq_len=seq_len, global_batch=global_batch, vocab=cfg.vocab,
                          seed=seed)
    mon = HeartbeatMonitor(["trainer"])
    losses = []
    t_last = time.time()
    it = batches(data_cfg, b_sh, start_step=start, device=device)
    try:
        for step in range(start, steps):
            batch = next(it)
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if (step + 1) % log_every == 0 or step + 1 == steps:
                loss = float(metrics["loss"])
                dt = (time.time() - t_last) / log_every * 1e3
                t_last = time.time()
                losses.append(loss)
                mon.report(Heartbeat("trainer", step, dt, time.time()))
                print(f"[train] step {step + 1:5d} loss {loss:.4f} ({dt:.0f} ms/step)",
                      flush=True)
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt_state})
        if mgr is not None:
            mgr.save(steps, {"params": params, "opt": opt_state}, blocking=True)
    finally:
        it.close()
        if mgr is not None:
            mgr.wait()
    return params, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="granite_3_2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu, where the kernels' plain versions run")
    args = ap.parse_args(argv)

    cfg = get_config(canon(args.arch))
    if args.smoke:
        cfg = dataclasses.replace(cfg.smoke(), activation_dtype="float32")
    mesh = make_production_mesh() if args.production_mesh else make_host_mesh()
    train(
        cfg,
        mesh,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        dist=DistConfig(seq_parallel=args.seq_parallel),
        fail_at=args.fail_at,
        device=_cli_device(args.device),
    )


if __name__ == "__main__":
    main()
