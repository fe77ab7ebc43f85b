#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper).

  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source, started
   together) and print ``ptxas``'s registers, spills and shared memory
   (static and dynamic) of each kernel, and whether ``ptxas`` serialised its
   ``wgmma``s; K3 and K3b are built uncapped and with a logit cap (a
   template flag); a K1 ``wgmma``, K3, K3b or K4 specialisation, capped or
   not, or a K4b kernel that
   spills, or one missing, or a bf16 K3b kernel whose ``wgmma``s ``ptxas``
   serialised, fails the run;
2. K1 (matmul) against its plain PyTorch version on the card, each case
   with the path the wrapper chose (``wgmma`` or ``fma``): 2048^3 f32 with a
   row-major B (the MM DAG's layout) and with the serving ``prefill``
   operand ``x.T``, 2048x1000x2048 f32 (K not a multiple of the 32-deep
   k-block), a ragged 2047x1999x1000 f32 (the ``fma`` path), 1024^3 bf16
   with a row-major B and with ``x.T``, and 512^3 with a transposed A;
3. K2 (matadd) bit-exact against its plain version: f32, bf16 and int32 at
   2048^2, (512, 384), (64, 128) and a ragged (33, 77), each case with the
   path the wrapper took: ``direct`` on contiguous operands, ``copy`` on
   transposed views, strided slices and halves of a reshaped transpose;
4. K3 (flash attention) against its plain version, each case with the path
   the wrapper took (``tma`` in bf16, ``fp32``, ``copy``, ``pad``): f32 and
   bf16 at head dims 32, 64 and 128, causal and not, ``kv_len`` < Sk and 0,
   Sq != Sk both ways, GQA 32/8 and 24/8, ragged S = 33 and 77, and the
   granite-3-2b and minitron-4b prefill shapes, on the model's strided (B,
   S, H, hd) views; whisper-large-v3's shapes: one query over 1500 encoder
   frames (its decode cross-attention), its 416-token prompt over them and
   1500 x 1500 (its encoder), not causal; head dims 4, 16 and 96
   zero-padded (``pad``) in both dtypes, 96 also at minicpm3-4b's MLA
   prefill shape (40 heads over 40); a bf16 view whose last dimension is
   strided, copied (``copy``); and capped (cap 5 over q and k 3 times unit
   normal, so the logits reach ~15) on every path: granite-3-2b's prefill
   shape, GQA 32/8, causal and not, ``kv_len`` < Sk and 0, Sq != Sk, head
   dims 32, 64, 128 and 96; then ``[K3-lse]``: the log-sum-exp rows K3
   writes for training (``flash_attention_fwd``) against the plain
   version's on the ``tma``, ``fp32`` and ``pad`` paths, uncapped and
   capped, the output bit-identical to a launch without them; and
   ``[K3b]``: the CUDA
   flash-attention backward's dq, dk and dv against its plain version, each
   case with its path (``tma``, ``fp32``, ``copy``, ``pad``): head dims 32,
   64, 128 and padded 16 and 96, causal and not, GQA 32/8, Sq != Sk both
   ways, ragged S = 33 and 130, one query row, ``kv_len`` < Sk and 0,
   granite-3-2b's training shape, minicpm3-4b's MLA at 96, whisper-large-v3's
   416 x 1500, a bf16 dout with a strided last dimension and a q whose base
   is 4 bytes off the 16-byte granule (``copy``), and capped on every path
   (the plain capped backward carries the cap's derivative); a second
   launch on the same inputs must give the same bits;
5. K4 (WKV6) against its plain version, output and final state, each case
   with the path the wrapper took (``ring``, ``copy`` where TMA cannot
   address the inputs or their strides differ and the wrapper copies them
   first, ``pad`` for a head size that is not built): on the ``ring`` path
   at N = 32 and 64, S = 33 and 2048, and the rwkv6-3b prefill shape, on
   the model's (B, S, H, N) views, and at S = 257 on contiguous (B, H, S, N)
   tensors; on the ``copy`` path a view with n-stride 2, a base 4 bytes off
   the 16-byte granule and unequal strides; on the ``pad`` path N = 4, 8 and
   16; then ``[K4b]``: the CUDA WKV6 backward's dr, dk, dv, dw and du against
   its plain version (``ref.wkv6_bwd``), each case with its path
   (``direct``, ``copy`` for a view with n-stride 2 or a base 4 bytes off
   the granule, ``pad`` for N = 4 and 16): N = 32 and 64, S = 33, 257 and
   2048, rwkv6-3b's training shape on the model's views, decays near 0 and
   near 1, with and without a final-state gradient, within 1e-4 x max|plain|
   each; a second launch on the same inputs must give the same bits;
6. each kernel's time at its main path's shape (median over batches
   bracketed by CUDA events) beside its plain version's, one PyTorch call's
   where one computes the same function, and the card's bound; K3 also at
   minitron-4b's, minicpm3-4b's, command-r-35b's (64 query heads over 8 of
   128) and whisper-large-v3's encoder and decode cross-attention shapes;
   K3 with its LSE and K3b at granite-3-2b's training shape, K3b beside the
   backward of SDPA and its five- and seven-product bounds; K3 and K3b
   capped at granite's shapes beside their plain versions, the larger of
   the tensor bound and the special-function floor (3 operations a kept
   pair at 16 a clock per SM) and ``flex_attention`` with the cap as its
   ``score_mod`` (forward, and ``torch.autograd.grad`` through it); K3 and
   K3b on their f32 paths (the CUDA cores) at lm-100m's training shape
   (``examples/train_lm_torch.py``: 4 x 128, 12 query heads over 4 of 64),
   each first held against its plain version, beside SDPA in f32 and its
   backward and their bounds at the f32 peak; K4b at rwkv6-3b's training
   shape beside its plain version and its bound;
7. one request chain executed on the card and on the CPU from the same
   inputs, outputs compared;
8. the executed serving arena: the pinned CI stream (12 requests, 6 decode
   chunks, 5 steps, a worker drop at step 2, seed 0) at 2048 x 2048 f32
   blocks on ``cuda:0`` under all five policies.  Launch counters are set
   to 0 just before and read just after: every ``prefill`` must have been a
   matmul launch on its ``wgmma`` path and every ``decode`` a matadd launch;
9. the fused path (``[fused]``, ``[arena-fused]``): tests/test_superstep.py's
   single chain and diamond at side 2048 and its typed K3 -> K4 chain run
   as CUDA graphs of group-steps, serialized and in async waves, captured
   and then replayed from the cache, bit-equal to the unfused run with every
   kernel counted through the replays; one graph replayed twice must leave
   the first outputs unchanged; then the CI stream at side 2048 under each
   policy, fused and fused with async waves (counters set to 0 just before
   each policy: every executed ``prefill``/``decode`` a K1/K2 launch through
   the replays), with wall, makespan, fused steps, waves, cache hits and
   misses, transfers, static-input copies and peak memory, and ``gp`` on a
   stream without arrival spread or drops equal to the CPU's counters;
10. a 2-layer, full-width cut in f32 (batch 2, prompt 128, after the VLM's
   576 patches; 4 decode steps) of granite-3-2b, rwkv6-3b,
   granite-moe-3b-a800m, minicpm3-4b, whisper-large-v3 (and 2 encoder
   layers over its 1500 frames), llava-next-mistral-7b, command-r-35b and
   jamba-1.5-large (layers 0 and 4 of its unit: a Mamba and the attention
   layer, each with a dense FFN) and the capped granite-3-2b (below; in
   the cut at caps of 0.5 with its queries and keys x4, so that the
   attention cap binds, which a run of the same cut without it on the
   card must show), run on the card and on the CPU from the same
   parameters: prefill and decode logits compared;
11. full-width serving through ``serve_smoke``, 32 greedy decode tokens,
   bf16 activations, 8 requests: granite-3-2b, rwkv6-3b, minitron-4b,
   granite-moe-3b-a800m, minicpm3-4b, llava-next-mistral-7b,
   command-r-35b (all 40 layers) and ``granite_3_2b+softcap``
   (granite-3-2b with its attention logits capped at 50 and its final
   logits at 30, the pair of Gemma 2's published configs: K3's capped
   specialisation) at 2048-token prompts (llava's are 576
   patches and 1472 text tokens), whisper-large-v3 at 416-token prompts
   over 1500 encoder frames, and deepseek-moe-16b cut to 4 layers (its
   dense prefix layer and three MoE layers); 4 requests of 2048 tokens:
   jamba-1.5-large cut to the first five layers of its unit (four Mamba,
   the attention layer, two MoE).  Before each of the first eight,
   ``[init]``: its weights drawn leaf by leaf in bf16 bit-equal to the f32
   tree cast afterwards.  Counters set to 0 just before each model: K3 must
   have run once per attention layer of the prefill, on ``tma`` (on
   ``pad`` for minicpm3-4b's head dim 96), and for whisper also once per
   encoder layer and once per cross-attention in the prefill and in each
   decode step (through the graph's replays); K4 32 times, all on its
   ``ring`` path; every decode step one replay of the captured CUDA graph;
   each ``[serve]`` line with the greedy tokens' sha256.  Then one prefill
   and 4 eager decode steps of granite-3-2b, rwkv6-3b,
   granite-moe-3b-a800m, minicpm3-4b and jamba under ``torch.profiler``:
   device kernel time against wall, and the kernels that take most of it;
   and ``[prefill-split]``, jamba's prefill timed layer by layer (Mamba
   mixers, MoE and dense FFNs, the attention layer) and its Mamba
   recurrence alone;
12. ``[decode-graph]``: each of the eleven models prefilled, then 32 decode
   steps from the same cache eagerly and through ``DecodeGraph`` (one CUDA
   graph per step), timed back to back: greedy tokens equal, the logits'
   largest difference, the capture's ms, ms per token of both, and the
   graph replays' device busy share under ``torch.profiler``;
13. ``[router]``: ``run_router`` under every routing mode with a drain
   (simulated); 3 ``ExecutorReplica``s on ``cuda:0`` at side 2048 behind
   the affinity router for 3 steps, K1/K2 launches (set to 0 just before)
   equal to the fleet's executed ``prefill``/``decode`` counts; the same
   fleet under a step clock on the card and on the CPU, both at side 2048:
   routing, warm hits and transfers equal;
14. ``[cli]``: ``--scheduler``, ``--arena --scenario moe``, ``--arena
   --replicas 3 --router all --drain-step 2`` and ``--smoke`` of
   ``python -m repro_torch.launch.serve`` (granite-3-2b, and the reduced
   granite-moe-3b-a800m, minicpm3-4b, whisper-large-v3,
   llava-next-mistral-7b, deepseek-moe-16b, jamba-1.5-large and
   command-r-35b), each a process of its own,
   all started together; each must exit 0;
15. training: ``[train-vs-cpu]``, one ``make_train_step`` step of a 2-layer,
   full-width cut of granite-3-2b, minicpm3-4b, whisper-large-v3 (and 2
   encoder layers), rwkv6-3b and the capped granite-3-2b (cut as in 10.)
   in f32 at batch 2 x 128 on the card and on
   the CPU from the same parameters (loss, ``grad_norm``, updated
   parameters and moments; rwkv6-3b's card step 4 K4 and 2 K4b launches);
   ``[train]``, granite-3-2b and then rwkv6-3b at full width and depth (f32
   parameters and AdamW state, bf16 activations, remat), 6 steps of 8 x
   2048 synthetic tokens each through ``launch.train.train``, then the
   capped granite-3-2b for 3 steps, the counters
   set to 0 just before: granite's K3 80 and K3b 40 launches a step, all on
   ``tma`` (the capped granite's on the capped kernels), rwkv6's K4 64 on
   ``ring`` and K4b 32 on ``direct`` (printed by
   path), losses finite and falling, every parameter moved, ms a step, tokens/s, peak
   memory, and one step under ``torch.profiler`` with the kernels' share;
   ``[train-restart]``, 2 full-width layers, a failure injected at step 7
   and a restart from the step-5 checkpoint, the losses after it against
   an uninterrupted run's; ``[train-cli]``, ``python -m
   repro_torch.launch.train --arch granite_3_2b --smoke --steps 4`` and the
   same with ``--arch rwkv6_3b``, which must exit 0;
16. ``[examples]``: the five ``examples/*_torch.py`` twins' ``main`` in
   this process with the reference scripts' arguments: ``quickstart_torch``
   on the card (its 38 matmuls 38 K1 launches, each against the plain
   version where that is finite) and on the CPU (the same schedule lines
   and transfers); ``heterogeneous_serving_torch`` (granite-3-2b's reduced
   config served in f32, K3 on ``fp32``, and the scheduler lines);
   ``online_repartition_torch`` and ``elastic_repartition_torch`` (host
   code); ``train_lm_torch``, lm-100m for 250 steps of 4 x 128 in a fresh
   checkpoint directory, the counters set to 0 just before: K3 and K3b
   2000 launches each on ``fp32`` (a layer and step, remat off), the loss
   falling.

The line before the last is a JSON object listing each kernel with its
launches on its main path, error, times and bound, and the capped K3 and
K3b (``flash_attention+cap``, ``flash_attention_bwd+cap``: the launches
their wrappers counted as capped on the main paths, the capped granite's,
which the kernel's own total also counts) and their f32 paths
(``flash_attention+f32``, ``flash_attention_bwd+f32``: the ``fp32``
launches of ``[examples]``, which the kernel's own total also counts); a ``[phase]`` line gives the
seconds elapsed after each phase; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
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

# published peaks of each H100 part (NVIDIA's H100 data sheet, dense rates
# without sparsity, full power limit): f32 FLOP/s outside the tensor cores,
# bf16 and tf32 FLOP/s on the tensor cores (tf32 half the bf16 rate), device
# memory bytes/s; the first key found in torch's device name wins (SXM5
# reports "NVIDIA H100 80GB HBM3")
PEAKS = (
    ("H100 PCIe", {"f32": 51e12, "bf16": 756e12, "tf32": 378e12, "bytes": 2.0e12}),
    ("H100 NVL", {"f32": 60e12, "bf16": 835e12, "tf32": 417.5e12, "bytes": 3.9e12}),
    ("H100", {"f32": 67e12, "bf16": 989e12, "tf32": 494.5e12, "bytes": 3.35e12}),
)
REPLACES = {
    "matmul": "src/repro/kernels/matmul.py:44",
    "matadd": "src/repro/kernels/matadd.py:28",
    "flash_attention": "src/repro/kernels/flash_attention.py:95",
    "wkv6": "src/repro/kernels/wkv6.py:52",
    # not a Pallas kernel: the reference's fusedkernel_flash_bwd region, the
    # backward of its flash attention's custom_vjp
    "flash_attention_bwd": "src/repro/models/layers.py:278",
    # not a Pallas kernel: the reference's autodiff of its checkpointed
    # chunked scan of the RWKV-6 recurrence
    "wkv6_bwd": "src/repro/models/rwkv.py:152",
}
# the main paths' shapes: granite-3-2b prefill attention (8 requests x 2048
# tokens, 32 query heads over 8 KV heads of 64), minitron-4b's (24 over 8 of
# 128) and rwkv6-3b prefill recurrence (40 heads of 64)
SERVE = dict(n_requests=8, prompt_len=2048, decode_len=32)
K3_SHAPE = (8, 32, 8, 2048, 64)    # B, H, K, S, hd
K3_MINITRON = (8, 24, 8, 2048, 128)
K3_MINICPM3 = (8, 40, 40, 2048, 96)  # MLA: qk_nope 64 + qk_rope 32, zero-padded to 128
K3_WHISPER = (8, 20, 20, 1500, 64)   # the encoder over its 1500 frames, not causal
K3_COMMAND_R = (8, 64, 8, 2048, 128)
K4_SHAPE = (8, 40, 2048, 64)       # B, H, S, N
# lm-100m's training attention (examples/train_lm_torch.py: batch 4 x 128,
# 12 query heads over 4 KV heads of 64), f32
LM100M_K3 = (4, 12, 4, 128, 64)
# every served model: (arch, the kernel its prefill runs, its prompt length,
# the config's one cut, its requests); "arch+variant" is the published config
# with the fields of the registry's VARIANTS[variant].  whisper-large-v3's
# decoder prompt is 416 tokens, so 416 + 32 stays inside its published 448-token text context
# (beside its 1500 encoder frames); llava-next-mistral-7b's 2048 positions
# are 576 patches and 1472 text tokens; deepseek-moe-16b keeps its dense
# prefix layer and three MoE units at full width (all 28 layers would hold
# ~98 GB); command-r-35b is served whole (64.8 GB in bf16); jamba-1.5-large
# keeps the first five layers of its 8-layer unit (four Mamba, the attention
# layer at index 4, two MoE: 48.1 GB in bf16; the whole unit holds ~90 GB)
# and 4 requests, as its MoE computes every expert for every token, (16, T,
# 24576) products of about 2.6 MB a token
SERVED = (("granite_3_2b", "flash_attention", 2048, {}, 8), ("rwkv6_3b", "wkv6", 2048, {}, 8),
          ("granite_3_2b+softcap", "flash_attention", 2048, {}, 8),
          ("minitron_4b", "flash_attention", 2048, {}, 8),
          ("granite_moe_3b_a800m", "flash_attention", 2048, {}, 8),
          ("minicpm3_4b", "flash_attention", 2048, {}, 8),
          ("whisper_large_v3", "flash_attention", 416, {}, 8),
          ("llava_next_mistral_7b", "flash_attention", 2048, {}, 8),
          ("deepseek_moe_16b", "flash_attention", 2048, {"n_layers": 4}, 8),
          ("command_r_35b", "flash_attention", 2048, {}, 8),
          ("jamba_1_5_large_398b", "flash_attention", 2048,
           {"n_layers": 5, "unit": slice(5)}, 4))
CARD_VS_CPU = ("granite_3_2b", "rwkv6_3b", "granite_moe_3b_a800m", "minicpm3_4b",
               "whisper_large_v3", "llava_next_mistral_7b", "command_r_35b",
               "jamba_1_5_large_398b", "granite_3_2b+softcap")
# [K3], [K3-lse] and [K3b]'s capped cases: a cap of 5 over q and k drawn 3
# times unit normal, so the scaled logits reach ~15 and the tanh saturates
CHECK_CAP, CHECK_CAP_INPUTS = 5.0, 3.0
# [card-vs-cpu] and [train-vs-cpu] cut an "arch+variant" config with the
# variant's caps at a cut's values (0.5) and its query and key projections
# scaled by this: its scaled attention logits, ~1 at init, grow 16-fold, so
# the attention cap binds hard (without it granite's 2-layer prefill logits
# move by ~1, against ~7e-4 at the weights as drawn)
CUT_QK_GAIN = 4.0
# [card-vs-cpu]'s 2 layers of a model whose unit is longer: which layers of
# the unit (jamba: a Mamba and the attention layer, each with a dense FFN)
CARD_VS_CPU_UNIT = {"jamba_1_5_large_398b": (0, 4)}
PROFILED = ("granite_3_2b", "rwkv6_3b", "granite_moe_3b_a800m", "minicpm3_4b",
            "jamba_1_5_large_398b")
# served models whose weights drawn in bf16 are checked against the f32 tree
# cast afterwards (``[init]``): those whose two trees fit the card together
# (command-r's and jamba's f32 trees do not fit it alone)
INIT_CHECKED = ("granite_3_2b", "rwkv6_3b", "minitron_4b", "granite_moe_3b_a800m",
                "minicpm3_4b", "whisper_large_v3", "llava_next_mistral_7b", "deepseek_moe_16b")
# served models whose prefill is also timed layer by layer (``[prefill-split]``)
PREFILL_SPLIT = ("jamba_1_5_large_398b",)
PROFILE_KEY = {"flash_attention": "flash_fwd", "wkv6": "wkv6"}  # in the kernels' names
# special-function (MUFU) operations an SM issues a clock (Hopper)
MUFU_PER_SM_CLOCK = 16


def bound(flops: float, nbytes: float, flop_rate: float, byte_rate: float
          ) -> tuple[float, str]:
    """-> (least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / flop_rate, nbytes / byte_rate
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


def _operand(rows, cols, dtype, transposed, gen):
    """A (rows, cols) operand on the card, row-major or the transposed view
    of a row-major (cols, rows) tensor."""
    if transposed:
        return torch.randn(cols, rows, device="cuda", generator=gen).to(dtype).T
    return torch.randn(rows, cols, device="cuda", generator=gen).to(dtype)


def check_matmul(matmul, ref, gen) -> float:
    """-> max |error| at the main path's shape (2048^3 f32, B = x.T).  Each
    case must take the path it names; f32 is also held to a float64 product
    of the same inputs, for the record."""
    from repro_torch.kernels.matmul import choose_path

    main_err = None
    cases = [  # M, K, N, dtype, A transposed, B transposed, path
        (2048, 2048, 2048, torch.float32, False, False, "wgmma"),
        (2048, 2048, 2048, torch.float32, False, True, "wgmma"),
        (2048, 1000, 2048, torch.float32, False, False, "wgmma"),
        (2047, 1999, 1000, torch.float32, False, False, "fma"),
        (1024, 1024, 1024, torch.bfloat16, False, False, "wgmma"),
        (1024, 1024, 1024, torch.bfloat16, False, True, "wgmma"),
        (512, 512, 512, torch.float32, True, False, "wgmma"),
        (512, 512, 512, torch.bfloat16, True, True, "wgmma"),
    ]
    for m, k, n, dt, a_t, b_t, want_path in cases:
        a = _operand(m, k, dt, a_t, gen)
        b = _operand(k, n, dt, b_t, gen)
        path, _ = choose_path(dt, m, k, n, a.stride(), b.stride(), a.data_ptr(), b.data_ptr())
        if path != want_path:
            raise AssertionError(f"matmul {m}x{k}x{n} {dt}: path {path}, want {want_path}")
        got = matmul(a, b)
        want = ref.matmul(a, b)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"matmul {m}x{k}x{n}: {got.shape} {got.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        tol = mm_tol(k, dt)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        f64 = ""
        if dt == torch.float32:
            exact = a.double() @ b.double()
            f64 = (f"; against float64 kernel {(got.double() - exact).abs().max().item():.3e}, "
                   f"plain {(want.double() - exact).abs().max().item():.3e}")
        layout = f"A{'=x.T' if a_t else ' row-major'}, B{'=x.T' if b_t else ' row-major'}"
        print(f"[K1] matmul {m}x{k}x{n} {str(dt)[6:]} {layout} path={path} max_abs_err={err} "
              f"(rtol=atol={tol['rtol']:.2e}) ok{f64}")
        if b_t and not a_t and m == 2048:
            main_err = err
    return main_err


def paths_taken(kernel, fn):
    """-> (fn's result, the paths of ``kernel`` whose launch counts it moved)."""
    before = dict(kernel.launches_by_path)
    out = fn()
    return out, [p for p, n in kernel.launches_by_path.items() if n != before.get(p, 0)]


def check_matadd(matadd, ref, gen) -> float:
    """Bit-exact against the plain version, each case on the path it names:
    contiguous operands read in place (``direct``), and a transposed view, a
    strided slice and a chain's reshape of a transposed block, copied
    contiguous first (``copy``)."""
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
            cases = [("contiguous", a, b, "direct")]
            if shape in ((2048, 2048), (33, 77)):
                cases += [("a.T + b.T", a.T, b.T, "copy"),
                          ("strided slices", a[:, ::2], b[:, ::2], "copy")]
            if shape == (2048, 2048):
                cases.append(("halves of a reshaped a.T", a.T.reshape(-1, 4096)[:, :2048],
                              b.reshape(-1, 4096)[:, 2048:], "copy"))
            for label, x, y, want_path in cases:
                got, taken = paths_taken(matadd, lambda: matadd(x, y))
                want = ref.matadd(x, y)
                torch.cuda.synchronize()
                if taken != [want_path]:
                    raise AssertionError(f"matadd {shape} {label}: paths {taken}, "
                                         f"want {want_path}")
                if not torch.equal(got, want):
                    raise AssertionError(f"matadd {shape} {dt} {label}: not bit-exact")
                if dt != torch.int32:
                    worst = max(worst, (got.float() - want.float()).abs().max().item())
                print(f"[K2] matadd {shape} {str(dt)[6:]} {label} path={taken[0]} "
                      f"bit-exact ok")
    return worst


def _strided(shape_bshd, dtype, gen, scale: float = 1.0):
    """A (B, S, H, d) tensor on the card, ``scale`` times unit normal,
    returned as its (B, H, S, d) view: the layout the model hands to K3 and
    K4."""
    x = torch.randn(shape_bshd, device="cuda", generator=gen)
    return (x * scale if scale != 1.0 else x).to(dtype).transpose(1, 2)


def _row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| / |want| over query rows (2-norms over hd)."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max().item()


def check_flash(flash, ref, gen) -> tuple[float, float]:
    """-> max |error| at the main path's shape, uncapped and capped.  Tolerances: the test
    suite's elementwise 2e-5 in f32 and 2e-2 in bf16 (rtol = atol), and per
    query row |got - plain| / |plain| (2-norms over hd) below 1e-4 in f32
    and 1e-2 in bf16.  A causal row averages up to S values of unit-normal
    V, so its entries shrink to ~0.05 at S = 2048; the elementwise bf16
    tolerance alone would pass errors of half their size, the per-row one
    holds each row to a few bf16 roundings of its own norm (for rows of
    fewer than 32 values, see below).  The capped cases (cap 5 over q and k
    3 times unit normal) are held to the plain capped version at the same
    tolerances."""
    main_err = capped_err = None
    B0, H0, K0, S0, hd0 = K3_SHAPE
    Bm, Hm, Km, Sm, hdm = K3_MINITRON
    cases = [  # B, H, K, Sq, Sk, hd, dtype, causal, kv_len
        (B0, H0, K0, S0, S0, hd0, torch.bfloat16, True, None),
        (2, 32, 8, 2048, 2048, 64, torch.float32, True, None),
        (2, 4, 4, 256, 256, 64, torch.float32, False, None),
        (2, 4, 2, 256, 256, 32, torch.bfloat16, False, None),
        (1, 4, 4, 128, 128, 64, torch.float32, True, 77),
        (1, 4, 4, 128, 128, 64, torch.bfloat16, False, 77),
        (1, 4, 2, 96, 160, 64, torch.float32, True, 0),
        (1, 4, 2, 96, 160, 32, torch.float32, False, 0),
        (2, 4, 4, 64, 192, 64, torch.float32, True, None),
        (2, 4, 4, 192, 64, 32, torch.float32, False, None),
        (2, 32, 8, 33, 33, 64, torch.float32, True, None),
        (2, 32, 8, 77, 77, 64, torch.bfloat16, True, None),
        # head_dim 128: minitron-4b's prefill shape, then the same classes
        (Bm, Hm, Km, Sm, Sm, hdm, torch.bfloat16, True, None),
        (2, 24, 8, 2048, 2048, 128, torch.float32, True, None),
        (2, 24, 8, 77, 77, 128, torch.bfloat16, True, None),
        (2, 24, 8, 77, 77, 128, torch.float32, True, None),
        (1, 4, 4, 128, 128, 128, torch.float32, True, 77),
        (1, 4, 4, 128, 128, 128, torch.bfloat16, False, 77),
        (1, 4, 2, 96, 160, 128, torch.float32, True, 0),
        (1, 4, 2, 96, 160, 128, torch.bfloat16, False, 0),
        (2, 4, 4, 64, 192, 128, torch.bfloat16, True, None),
        (2, 4, 4, 64, 192, 128, torch.float32, False, None),
        (2, 4, 4, 192, 64, 128, torch.bfloat16, True, None),
        (2, 4, 4, 192, 64, 128, torch.float32, False, None),
        # whisper-large-v3: the decode's cross-attention (one query over the
        # 1500 encoder frames, inside the captured decode graph), the
        # decoder's causal self-attention over its 416-token prompt, the
        # prefill's cross-attention (the prompt over the frames) and the
        # encoder's (1500 x 1500, not causal); neither 416 nor 1500 is a
        # multiple of a key tile
        (8, 20, 20, 1, 1500, 64, torch.bfloat16, False, None),
        (8, 20, 20, 416, 416, 64, torch.bfloat16, True, None),
        (2, 20, 20, 1, 1500, 64, torch.float32, False, None),
        (8, 20, 20, 416, 1500, 64, torch.bfloat16, False, None),
        (8, 20, 20, 1500, 1500, 64, torch.bfloat16, False, None),
        (2, 20, 20, 1500, 1500, 64, torch.float32, False, None),
        # minicpm3-4b's MLA prefill: head dim 96 over 40 heads, zero-padded
        (8, 40, 40, 2048, 2048, 96, torch.bfloat16, True, None),
        (2, 40, 40, 512, 512, 96, torch.float32, True, None),
        # the other served prefills: granite-moe-3b-a800m, llava-next-mistral-7b
        # (576 patches + 1472 text tokens) and deepseek-moe-16b
        (8, 24, 8, 2048, 2048, 64, torch.bfloat16, True, None),
        (8, 32, 8, 2048, 2048, 128, torch.bfloat16, True, None),
        (8, 16, 16, 2048, 2048, 128, torch.bfloat16, True, None),
    ]
    # head dims that are not built, zero-padded up to the next built one
    # (minicpm3-4b's MLA attends at 96), and a bf16 view TMA cannot address
    for hd in (4, 16, 96):
        for dt in (torch.float32, torch.bfloat16):
            cases.append((2, 4, 2, 130, 130, hd, dt, True, None))
    cases.append((2, 4, 2, 130, 130, 96, torch.bfloat16, False, 77))
    cases.append((1, 4, 4, 128, 128, 64, torch.bfloat16, True, "strided"))
    cases = [(*c, 0.0) for c in cases]
    # capped (a model's attn_logit_softcap) on every path: granite-3-2b's
    # prefill shape, GQA 32/8, causal and not, kv_len < Sk and 0, Sq != Sk
    # both ways, head dims 32, 64, 128 and 96 (pad), a strided view (copy)
    bf16, f32 = torch.bfloat16, torch.float32
    cases += [(*c, CHECK_CAP) for c in (
        (B0, H0, K0, S0, S0, hd0, bf16, True, None),
        (2, 32, 8, 512, 512, 64, f32, True, None),
        (2, 4, 4, 256, 256, 64, f32, False, None),
        (2, 4, 2, 256, 256, 32, bf16, False, None),
        (1, 4, 4, 128, 128, 64, f32, True, 77),
        (1, 4, 4, 128, 128, 128, bf16, False, 77),
        (1, 4, 2, 96, 160, 64, f32, True, 0),
        (1, 4, 2, 96, 160, 128, bf16, False, 0),
        (2, 24, 8, 77, 77, 128, bf16, True, None),
        (2, 24, 8, 77, 77, 128, f32, True, None),
        (2, 4, 4, 64, 192, 32, f32, True, None),
        (2, 4, 4, 192, 64, 128, bf16, True, None),
        (2, 40, 40, 512, 512, 96, bf16, True, None),
        (2, 4, 2, 130, 130, 96, f32, True, None),
        (1, 4, 4, 128, 128, 64, bf16, True, "strided"))]
    for B, H, K, Sq, Sk, hd, dt, causal, kv_len, cap in cases:
        x = CHECK_CAP_INPUTS if cap else 1.0
        if kv_len == "strided":  # a strided last dimension: the copy path
            kv_len = None
            q, k, v = (_strided((B, S, heads, 2 * hd), dt, gen, sc)[..., ::2]
                       for S, heads, sc in ((Sq, H, x), (Sk, K, x), (Sk, K, 1.0)))
        else:
            q = _strided((B, Sq, H, hd), dt, gen, x)
            k = _strided((B, Sk, K, hd), dt, gen, x)
            v = _strided((B, Sk, K, hd), dt, gen)
        got, taken = paths_taken(flash, lambda: flash(q, k, v, causal=causal, kv_len=kv_len,
                                                      cap=cap))
        want = ref.flash_attention(q, k, v, causal=causal, kv_len=kv_len, cap=cap)
        want_path = ("pad" if hd not in (32, 64, 128) else "fp32" if dt == torch.float32
                     else "copy" if q.stride(-1) != 1 else "tma")
        if taken != [want_path]:
            raise AssertionError(f"flash_attention hd{hd} {dt}: paths {taken}, "
                                 f"want {want_path}")
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"flash_attention: {got.shape} {got.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        row_err = _row_err(got, want)
        tol, row_tol = (2e-2, 1e-2) if dt == torch.bfloat16 else (2e-5, 1e-4)
        if dt == torch.bfloat16 and hd < 32:
            # a row of a few values does not average out the rounding of P to
            # bf16: hold it to twice the plain bf16 version's own largest row
            # error against the f32 product of the same inputs, where that
            # is above 1e-2
            exact = ref.flash_attention(q.float(), k.float(), v.float(), causal=causal,
                                        kv_len=kv_len, cap=cap)
            row_tol = max(row_tol, 2 * _row_err(want, exact))
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        if not row_err < row_tol:
            raise AssertionError(f"flash_attention B{B} H{H}/K{K} Sq{Sq} Sk{Sk} hd{hd} {dt} "
                                 f"cap {cap:g}: row relative error {row_err} >= {row_tol}")
        print(f"[K3] flash_attention B{B} H{H}/K{K} Sq{Sq} Sk{Sk} hd{hd} {str(dt)[6:]} "
              f"causal={causal} kv_len={kv_len}"
              + (f" cap={cap:g} (q, k x{x:g})" if cap else "")
              + f" last-dim stride {q.stride(-1)} "
              f"path={taken[0]} max_abs_err={err} (rtol=atol={tol:g}) "
              f"max_row_rel_err={row_err:.3e} (< {row_tol:g}) ok")
        if main_err is None:
            main_err = err
        if cap and capped_err is None:
            capped_err = err
    return main_err, capped_err


def check_flash_lse(gen) -> None:
    """``[K3-lse]``: K3's log-sum-exp rows (``flash_attention_fwd``) against
    the plain version's, on the ``tma``, ``fp32`` and ``pad`` paths, causal
    or not, GQA, ``kv_len`` < Sk, uncapped and capped (cap 5 over q and k 3
    times unit normal: the LSE of the capped logits); the output
    bit-identical to a launch without the LSE.  Tolerance rtol = atol = 1e-5 in f32 and 1e-4 in bf16:
    the logits of bf16 inputs are exact f32 products in both versions, but
    the bf16 kernel sums ``ex2.approx`` terms (relative error ~2^-22 each)
    and takes its log in base 2."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_fwd

    cases = [  # B, H, K, Sq, Sk, hd, dtype, causal, kv_len, path
        (2, 32, 8, 2048, 2048, 64, torch.bfloat16, True, None, "tma"),
        (2, 8, 8, 416, 1500, 64, torch.bfloat16, False, None, "tma"),
        (2, 8, 2, 130, 130, 128, torch.bfloat16, True, 77, "tma"),
        (2, 8, 2, 130, 130, 32, torch.bfloat16, False, None, "tma"),
        (2, 32, 8, 512, 512, 64, torch.float32, True, None, "fp32"),
        (2, 8, 2, 130, 190, 128, torch.float32, False, 77, "fp32"),
        (2, 8, 8, 256, 256, 96, torch.bfloat16, True, None, "pad"),
        (2, 8, 2, 130, 130, 16, torch.float32, True, None, "pad"),
    ]
    cases = [(*c, 0.0) for c in cases] + [(*c, CHECK_CAP) for c in (
        (2, 32, 8, 2048, 2048, 64, torch.bfloat16, True, None, "tma"),
        (2, 8, 2, 130, 130, 128, torch.bfloat16, False, 77, "tma"),
        (2, 8, 2, 130, 130, 32, torch.bfloat16, True, 0, "tma"),
        (2, 32, 8, 512, 512, 64, torch.float32, True, None, "fp32"),
        (2, 8, 2, 130, 190, 128, torch.float32, False, 77, "fp32"),
        (2, 8, 8, 256, 256, 96, torch.bfloat16, True, None, "pad"))]
    for B, H, K, Sq, Sk, hd, dt, causal, kv_len, want_path, cap in cases:
        x = CHECK_CAP_INPUTS if cap else 1.0
        q = _strided((B, Sq, H, hd), dt, gen, x)
        k = _strided((B, Sk, K, hd), dt, gen, x)
        v = _strided((B, Sk, K, hd), dt, gen)
        kw = dict(causal=causal, kv_len=kv_len, cap=cap)
        (o, lse), taken = paths_taken(flash_attention,
                                      lambda: flash_attention_fwd(q, k, v, **kw))
        plain = flash_attention(q, k, v, **kw)
        want_o, want_lse = ref.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        if taken != [want_path]:
            raise AssertionError(f"flash_attention_fwd hd{hd} {dt}: paths {taken}, "
                                 f"want {want_path}")
        if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
            raise AssertionError(f"flash_attention_fwd lse {lse.shape} {lse.dtype}")
        if not torch.equal(o, plain):
            raise AssertionError(f"flash_attention_fwd B{B} H{H} Sq{Sq} hd{hd} {dt}: output "
                                 f"differs from the launch without the LSE")
        tol = 1e-4 if dt == torch.bfloat16 else 1e-5
        torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
        err = (lse - want_lse).abs().max().item()
        print(f"[K3-lse] B{B} H{H}/K{K} Sq{Sq} Sk{Sk} hd{hd} {str(dt)[6:]} causal={causal} "
              f"kv_len={kv_len}" + (f" cap={cap:g} (q, k x{x:g})" if cap else "")
              + f" path={taken[0]} lse max_abs_err={err:.3e} (rtol=atol={tol:g}); "
              f"output bit-identical to the launch without the LSE ok")


def check_flash_bwd(gen) -> tuple[float, float]:
    """``[K3b]``: dq, dk and dv of the CUDA backward against the plain
    version's (``ref.flash_attention_bwd``), both fed the same q, k, v, o,
    LSE (K3's forward) and dout, each case on the path it names (``tma``,
    ``fp32``, ``copy`` for a bf16 dout with a strided last dimension and a q
    whose base is 4 bytes off the 16-byte granule, or ``pad``); a second
    launch on the same inputs must give the same bits (no atomics).  The
    capped cases (cap 5 over q and k 3 times unit normal) run the capped
    kernels, held to the plain capped backward (which carries the cap's
    derivative) at the same tolerances.  -> the largest error at
    granite-3-2b's training shape, uncapped and capped.

    Tolerance, on each gradient, max |kernel - plain| <= tol x max |plain|:
    1e-4 in f32 (sums of up to Sq x G terms taken in another order) and
    1e-2 in bf16, K3's bf16 tolerance: P and dS are rounded to bf16 before
    their products in both versions, and a sum taken in another order can
    round an element one bf16 step (2^-8) the other way."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    B0, H0, K0, S0, hd0 = K3_SHAPE
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # B, H, K, Sq, Sk, hd, dtype, causal, kv_len
        (B0, H0, K0, S0, S0, hd0, bf16, True, None),  # granite-3-2b's training shape
        (8, 40, 40, 2048, 2048, 96, bf16, True, None),  # minicpm3-4b's MLA, pad
        (8, 20, 20, 416, 1500, 64, bf16, False, None),  # whisper's cross-attention
        (2, 32, 8, 512, 512, 64, f32, True, None),    # GQA 32/8
        (2, 32, 8, 512, 512, 64, bf16, False, None),
        (2, 4, 4, 256, 256, 32, f32, True, None),
        (2, 4, 4, 256, 256, 32, bf16, False, None),
        (2, 4, 2, 256, 256, 128, f32, True, None),
        (2, 4, 2, 256, 256, 128, bf16, True, None),
        (2, 4, 2, 130, 130, 128, f32, False, None),
        (2, 4, 4, 64, 192, 64, f32, True, None),      # Sq < Sk
        (2, 4, 4, 192, 64, 64, bf16, True, None),     # Sq > Sk
        (2, 4, 4, 192, 64, 128, f32, False, None),
        (2, 4, 2, 33, 33, 64, f32, True, None),       # ragged
        (2, 4, 2, 33, 33, 64, bf16, True, None),
        (2, 4, 2, 130, 130, 64, f32, True, None),
        (2, 4, 2, 130, 130, 32, bf16, False, None),
        (1, 4, 4, 128, 160, 64, f32, True, 77),       # kv_len < Sk
        (1, 4, 4, 128, 160, 64, bf16, False, 77),
        (2, 4, 2, 130, 130, 16, f32, True, None),     # padded head dims
        (2, 4, 2, 130, 130, 16, bf16, False, None),
        (2, 8, 8, 256, 256, 96, f32, True, None),
        (2, 8, 8, 256, 256, 96, bf16, False, 200),
        (1, 4, 4, 128, 160, 64, bf16, True, 0),       # kv_len 0: every key masked
        (2, 4, 4, 1, 300, 64, bf16, False, None),     # one query row
        # TMA cannot address them: the copy path
        (2, 32, 8, 512, 512, 64, bf16, True, "strided dout"),
        (2, 4, 2, 130, 200, 128, bf16, False, "offset q"),
    ]
    cases = [(*c, 0.0) for c in cases] + [(*c, CHECK_CAP) for c in (
        (B0, H0, K0, S0, S0, hd0, bf16, True, None),  # granite-3-2b's training shape
        (2, 32, 8, 512, 512, 64, f32, True, None),    # GQA 32/8
        (2, 32, 8, 512, 512, 64, bf16, False, None),
        (2, 4, 4, 256, 256, 32, f32, False, None),
        (2, 4, 4, 256, 256, 32, bf16, True, None),
        (2, 4, 2, 256, 256, 128, f32, True, None),
        (2, 4, 2, 256, 256, 128, bf16, True, None),
        (2, 4, 4, 192, 64, 64, bf16, True, None),     # Sq > Sk
        (2, 4, 4, 64, 192, 128, f32, True, None),     # Sq < Sk
        (2, 4, 2, 130, 130, 64, bf16, True, None),    # ragged
        (1, 4, 4, 128, 160, 64, f32, True, 77),       # kv_len < Sk
        (1, 4, 4, 128, 160, 128, bf16, False, 77),
        (1, 4, 4, 128, 160, 64, bf16, True, 0),       # kv_len 0
        (2, 8, 8, 256, 256, 96, bf16, True, None),    # pad
        (2, 8, 8, 256, 256, 96, f32, False, 200),
        (2, 32, 8, 512, 512, 64, bf16, True, "strided dout"),  # copy
        (2, 4, 2, 130, 200, 128, bf16, False, "offset q"))]
    main_err = capped_err = None
    for B, H, K, Sq, Sk, hd, dt, causal, kv_len, cap in cases:
        layout = kv_len if isinstance(kv_len, str) else None
        kv_len = None if layout else kv_len
        x = CHECK_CAP_INPUTS if cap else 1.0
        if layout == "offset q":  # the base 4 bytes past an allocation's
            buf = torch.randn(B * Sq * H * hd + 2, device="cuda", generator=gen)
            q = (buf * x if cap else buf).to(dt)[2:].view(B, Sq, H, hd).transpose(1, 2)
        else:
            q = _strided((B, Sq, H, hd), dt, gen, x)
        k = _strided((B, Sk, K, hd), dt, gen, x)
        v = _strided((B, Sk, K, hd), dt, gen)
        if layout == "strided dout":
            dout = _strided((B, Sq, H, 2 * hd), dt, gen)[..., ::2]
        else:
            dout = _strided((B, Sq, H, hd), dt, gen)
        kw = dict(causal=causal, kv_len=kv_len, cap=cap)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        got, taken = paths_taken(flash_attention_bwd,
                                 lambda: flash_attention_bwd(q, k, v, o, lse, dout, **kw))
        again = flash_attention_bwd(q, k, v, o, lse, dout, **kw)
        want = ref.flash_attention_bwd(q, k, v, o, lse, dout, **kw)
        torch.cuda.synchronize()
        want_path = ("pad" if hd not in (32, 64, 128) else "fp32" if dt == f32
                     else "copy" if layout else "tma")
        if taken != [want_path]:
            raise AssertionError(f"flash_attention_bwd hd{hd} {dt}: paths {taken}, "
                                 f"want {want_path}")
        tol = 1e-2 if dt == bf16 else 1e-4
        errs, worst = [], 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"flash_attention_bwd {name}: {g.shape} {g.dtype}, want "
                                     f"{w.shape} {w.dtype}")
            scale = w.float().abs().max().item()
            err = (g.float() - w.float()).abs().max().item()
            if not (torch.isfinite(g).all() and err <= tol * scale):
                raise AssertionError(f"flash_attention_bwd B{B} H{H}/K{K} Sq{Sq} Sk{Sk} hd{hd} "
                                     f"{dt} causal={causal} kv_len={kv_len} cap={cap:g}: {name} "
                                     f"max_abs_err {err} > {tol:g} x max|plain| {scale}")
            errs.append(f"{name} {err:.3e} (max|plain| {scale:.3e})")
            worst = max(worst, err)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd B{B} H{H}/K{K} Sq{Sq} Sk{Sk} hd{hd} {dt}: "
                                 f"two launches on the same inputs differ")
        if main_err is None:
            main_err = worst
        if cap and capped_err is None:
            capped_err = worst
        print(f"[K3b] flash_attention_bwd B{B} H{H}/K{K} Sq{Sq} Sk{Sk} hd{hd} {str(dt)[6:]} "
              f"causal={causal} kv_len={kv_len}{f' ({layout})' if layout else ''}"
              + (f" cap={cap:g} (q, k x{x:g})" if cap else "")
              + f" path={taken[0]} max_abs_err " + ", ".join(errs)
              + f" (<= {tol:g} x max|plain|); a second launch bit-equal ok")
        del q, k, v, dout, o, lse, got, again, want
    return main_err, capped_err


def flex_capped(q, k, v, cap: float, causal: bool = True):
    """-> (fn, (q, k, v) as contiguous copies): ``fn(q, k, v)`` is attention
    capped at ``cap`` by ``torch.nn.attention.flex_attention`` on (B, H, S,
    hd) tensors, K and V with fewer heads (``enable_gqa``): a ``score_mod``
    of ``cap * tanh(s / cap)`` on the scaled logits and, causal, a
    ``BlockMask`` of ``q_idx >= kv_idx``.  The library call that computes
    the capped K3 and K3b's function (the port never calls it), compiled by
    ``torch.compile`` at its first call, in one thread, with its caches
    under the kernels' build directory; its backward kept for a second
    ``torch.autograd.grad`` (no donated buffers)."""
    from repro_torch.kernels._build import BUILD_DIR

    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(BUILD_DIR / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import torch._functorch.config
    import torch._inductor.config
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    torch._inductor.config.compile_threads = 1
    torch._functorch.config.donated_buffer = False

    def softcap(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    mask = (create_block_mask(lambda b, h, q_idx, kv_idx: q_idx >= kv_idx, None, None,
                              q.shape[2], k.shape[2], device=q.device) if causal else None)
    compiled = torch.compile(flex_attention, dynamic=False)
    gqa = q.shape[1] != k.shape[1]
    return ((lambda q, k, v: compiled(q, k, v, score_mod=softcap, block_mask=mask,
                                      enable_gqa=gqa)),
            tuple(t.contiguous() for t in (q, k, v)))


def time_flash_bwd(gen, peaks, cap: float = 0.0) -> tuple[tuple, tuple, tuple, float, dict]:
    """-> ((K3b ms, plain ms, library backward ms), bound, the design's bound,
    K3-with-LSE ms, {K3b's kernel: device ms a launch}) in bf16 at
    granite-3-2b's training shape, on the model's strided views, with a
    logit cap where ``cap > 0``; the split
    by kernel (its three launches) from ``torch.profiler`` over 5 calls.
    The bound counts the five products of a backward that recomputes P, 10
    hd operations per (query, key) pair the causal mask keeps, against the
    bf16 tensor peak, over q, k, v, o, dout and the LSE read once and dq,
    dk, dv written once; the design's bound the seven products of K3b's two
    kernels (14 hd a pair), which both compute S and dP.  Capped, the bound
    is the larger of the five-product bound and the function's
    special-function floor, 3 MUFU operations a kept pair (the tanh's ex2
    and rcp, P's ex2) at ``peaks["mufu"]``; the design's the larger of the
    seven-product bound and 6 operations a pair, as both kernels recompute
    the tanh and P.  The library call: ``torch.autograd.grad`` (the backward
    alone) through ``scaled_dot_product_attention(is_causal=True)``, K and
    V expanded to the query heads outside the timed call; capped, through
    :func:`flex_capped`, its gradients first held against K3b's at K3b's
    tolerance."""
    import re

    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    B, H, K, S, hd = K3_SHAPE
    q = _strided((B, S, H, hd), torch.bfloat16, gen)
    k = _strided((B, S, K, hd), torch.bfloat16, gen)
    v = _strided((B, S, K, hd), torch.bfloat16, gen)
    dout = _strided((B, S, H, hd), torch.bfloat16, gen)
    o, lse = flash_attention_fwd(q, k, v, cap=cap)
    pairs = B * H * S * (S + 1) / 2
    nbytes = (4 * B * H * S * hd + 4 * B * K * S * hd) * 2 + B * H * S * 4
    bnd = bound(10.0 * pairs * hd, nbytes, peaks["bf16"], peaks["bytes"])
    bnd7 = bound(14.0 * pairs * hd, nbytes, peaks["bf16"], peaks["bytes"])
    if cap:
        bnd = max(bnd, (3.0 * pairs / peaks["mufu"] * 1e3, "operations"))
        bnd7 = max(bnd7, (6.0 * pairs / peaks["mufu"] * 1e3, "operations"))
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout, cap=cap), batches=5,
                 per_batch=5)
    plain = time_ms(lambda: ref.flash_attention_bwd(q, k, v, o, lse, dout, cap=cap), batches=3,
                    per_batch=1)
    if cap:
        fn, args = flex_capped(q, k, v, cap)
        qs, ks, vs = (t.requires_grad_() for t in args)
        out = fn(qs, ks, vs)
        grads = flash_attention_bwd(q, k, v, o, lse, dout, cap=cap)
        for name, got, want in zip(("dq", "dk", "dv"), grads,
                                   torch.autograd.grad(out, (qs, ks, vs), dout)):
            err, scale = (got.float() - want.float()).abs().max().item(), want.abs().max().item()
            if not err <= 1e-2 * scale:
                raise AssertionError(f"flex_attention's capped {name} off K3b's by {err} "
                                     f"(largest {scale})")
        out = fn(qs, ks, vs)
    else:
        qs, ks, vs = (t.detach().requires_grad_() for t in
                      (q, k.repeat_interleave(H // K, dim=1), v.repeat_interleave(H // K, dim=1)))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True))
    fwd_lse = time_ms(lambda: flash_attention_fwd(q, k, v, cap=cap))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flash_attention_bwd(q, k, v, o, lse, dout, cap=cap)
        torch.cuda.synchronize()
    split = {m.group(1): t / 5 for name, t in _kernel_ms(prof)[0].items()
             if (m := re.search(r"(bwd_\w+(?:<[^>]*>)?)", name))}
    return (ms, plain, lib), bnd, bnd7, fwd_lse, split


def wkv6_inputs(B, H, S, N, gen, layout: str = "bshn"):
    """r, k, v unit normal, w = sigmoid(normal) in (0, 1), u = 0.1 normal:
    the reference suite's distributions, as (B, H, S, N) views of (B, S, H,
    N) tensors (``bshn``, the model's layout), as contiguous (B, H, S, N)
    tensors (``bhsn``), as views with n-stride 2 (``n-stride 2``), or as
    contiguous tensors whose base is 4 bytes past the 16-byte granule
    (``offset``)."""
    def make(f):
        if layout == "bhsn":
            return f(torch.randn((B, H, S, N), device="cuda", generator=gen))
        if layout == "offset":
            x = torch.randn((B * H * S * N + 1,), device="cuda", generator=gen)
            return f(x)[1:].view(B, H, S, N)
        if layout == "n-stride 2":
            x = torch.randn((B, S, H, 2 * N), device="cuda", generator=gen)
            return f(x)[..., ::2].transpose(1, 2)
        return f(torch.randn((B, S, H, N), device="cuda", generator=gen)).transpose(1, 2)

    r, k, v = (make(lambda x: x) for _ in range(3))
    w = make(torch.sigmoid)
    u = 0.1 * torch.randn((H, N), device="cuda", generator=gen)
    return r, k, v, w, u


def check_wkv6(wkv6, ref, gen) -> float:
    """-> max |error| at the main path's shape.  Tolerance: the suite's 1e-5
    as rtol, and atol 1e-5 x the largest plain value (the sums over N are
    taken in another order, so the absolute error grows with the values).
    Each case must take the path it names, read from the wrapper's counts."""
    main_err = None
    cases = [(*K4_SHAPE, "bshn", "ring"), (2, 4, 33, 32, "bshn", "ring"),
             (2, 4, 33, 64, "bshn", "ring"), (2, 4, 2048, 32, "bshn", "ring"),
             (2, 4, 2048, 64, "bshn", "ring"), (2, 4, 257, 32, "bhsn", "ring"),
             (2, 4, 257, 64, "bhsn", "ring"), (2, 4, 257, 64, "n-stride 2", "copy"),
             (2, 4, 257, 32, "offset", "copy"), (2, 4, 257, 64, "unequal strides", "copy"),
             (2, 4, 257, 4, "bshn", "pad"), (2, 4, 257, 8, "bshn", "pad"),
             (2, 4, 257, 16, "bhsn", "pad"), (2, 4, 2048, 16, "bshn", "pad")]
    for B, H, S, N, layout, want_path in cases:
        if layout == "unequal strides":  # k contiguous (B, H, S, N), the rest bshn
            r, _, v, w, u = wkv6_inputs(B, H, S, N, gen)
            k = wkv6_inputs(B, H, S, N, gen, "bhsn")[1]
        else:
            r, k, v, w, u = wkv6_inputs(B, H, S, N, gen, layout)
        before = dict(wkv6.launches_by_path)
        o, state = wkv6(r, k, v, w, u)
        taken = [p for p, n in wkv6.launches_by_path.items() if n != before.get(p, 0)]
        if taken != [want_path]:
            raise AssertionError(f"wkv6 B{B} H{H} S{S} N{N} {layout}: paths {taken}, "
                                 f"want {want_path}")
        path = taken[0]
        want_o, want_state = ref.wkv6(r, k, v, w, u)
        torch.cuda.synchronize()
        err = 0.0
        for got, want in ((o, want_o), (state, want_state)):
            if got.shape != want.shape:
                raise AssertionError(f"wkv6: {got.shape} != {want.shape}")
            scale = max(1.0, want.abs().max().item())
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
            err = max(err, (got - want).abs().max().item())
        print(f"[K4] wkv6 B{B} H{H} S{S} N{N} {layout} path={path} max_abs_err={err} "
              f"(o and state; rtol=1e-5, atol=1e-5 x max|plain|) ok")
        if main_err is None:
            main_err = err
    return main_err


def wkv6_bwd_inputs(B, H, S, N, gen, layout: str, decay: str, with_dstate: bool):
    """K4's inputs (:func:`wkv6_inputs`), the outputs' gradient ``do`` in the
    same layout and, where asked, a final-state gradient, all unit normal;
    w sigmoid(normal), or exp(-exp(normal + 2)) near 0 or exp(-exp(normal -
    8)) near 1 (the model's form, as ``tests/test_torch_wkv6_bwd.py``)."""
    r, k, v, w, u = wkv6_inputs(B, H, S, N, gen, layout)
    do, x = wkv6_inputs(B, H, S, N, gen, layout)[:2]
    if decay != "sigmoid":
        w = torch.exp(-torch.exp(x + (2.0 if decay == "near0" else -8.0)))
    dstate = (torch.randn((B, H, N, N), device="cuda", generator=gen) if with_dstate
              else None)
    return r, k, v, w, u, do, dstate


def check_wkv6_bwd(gen) -> float:
    """``[K4b]``: dr, dk, dv, dw and du of the CUDA WKV6 backward against
    the plain version's (``ref.wkv6_bwd``), each case on the path it names
    (``direct``, ``copy`` for a view the 16-byte loads cannot address,
    ``pad`` for a head size that is not built); a second launch on the same
    inputs must give the same bits (no atomics).  -> the largest error at
    rwkv6-3b's training shape.  Tolerance, on each gradient, max |kernel -
    plain| <= 1e-4 x max |plain| (K3b's f32 rule: sums over N and over S
    taken in another order)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6_bwd import wkv6_bwd

    cases = [  # B, H, S, N, layout, decay, with a final-state gradient, path
        (*K4_SHAPE, "bshn", "sigmoid", False, "direct"),   # rwkv6-3b's training shape
        (*K4_SHAPE, "bshn", "near1", True, "direct"),
        (2, 4, 33, 32, "bshn", "sigmoid", True, "direct"),
        (2, 4, 33, 64, "bshn", "sigmoid", False, "direct"),
        (2, 4, 257, 32, "bhsn", "near0", True, "direct"),
        (2, 4, 257, 64, "bhsn", "near1", False, "direct"),
        (2, 4, 257, 64, "bshn", "near0", False, "direct"),
        (2, 4, 257, 32, "bshn", "near1", True, "direct"),
        (2, 4, 2048, 32, "bshn", "sigmoid", True, "direct"),
        (2, 4, 2048, 64, "bshn", "near0", True, "direct"),
        (2, 4, 65, 64, "bshn", "sigmoid", True, "direct"),     # one step past a segment
        (2, 4, 130, 64, "bshn", "near1", False, "direct"),     # two segments and two steps
        (2, 4, 130, 32, "bhsn", "near0", True, "direct"),
        (2, 4, 257, 64, "n-stride 2", "sigmoid", True, "copy"),
        (2, 4, 257, 32, "offset", "sigmoid", False, "copy"),
        (2, 4, 257, 4, "bshn", "sigmoid", True, "pad"),
        (2, 4, 257, 16, "bhsn", "near0", False, "pad"),
        (2, 4, 33, 16, "bshn", "near1", True, "pad"),
    ]
    main_err = None
    for B, H, S, N, layout, decay, with_dstate, want_path in cases:
        ins = wkv6_bwd_inputs(B, H, S, N, gen, layout, decay, with_dstate)
        got, taken = paths_taken(wkv6_bwd, lambda: wkv6_bwd(*ins))
        again = wkv6_bwd(*ins)
        want = ref.wkv6_bwd(*ins)
        torch.cuda.synchronize()
        label = (f"B{B} H{H} S{S} N{N} {layout} w {decay} "
                 f"{'with' if with_dstate else 'without'} dstate")
        if taken != [want_path]:
            raise AssertionError(f"wkv6_bwd {label}: paths {taken}, want {want_path}")
        errs, worst = [], 0.0
        for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
            if g.shape != w.shape:
                raise AssertionError(f"wkv6_bwd {name}: {g.shape}, want {w.shape}")
            scale = w.abs().max().item()
            err = (g - w).abs().max().item()
            if not (torch.isfinite(g).all() and err <= 1e-4 * scale):
                raise AssertionError(f"wkv6_bwd {label}: {name} max_abs_err {err} > 1e-4 x "
                                     f"max|plain| {scale}")
            errs.append(f"{name} {err:.3e} (max|plain| {scale:.3e})")
            worst = max(worst, err)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"wkv6_bwd {label}: two launches on the same inputs differ")
        if main_err is None:
            main_err = worst
        print(f"[K4b] wkv6_bwd {label} path={taken[0]} max_abs_err " + ", ".join(errs)
              + " (<= 1e-4 x max|plain|); a second launch bit-equal ok")
        del ins, got, again, want
        torch.cuda.empty_cache()
    return main_err


def time_wkv6_bwd(gen, peaks) -> tuple[tuple, tuple, dict, int]:
    """-> ((K4b ms, plain ms, None), bound, {K4b's pass: device ms a
    launch}, checkpoint scratch bytes) at rwkv6-3b's training shape on the
    model's views, without a final-state gradient (the model's case); the
    split by pass (its three launches) from ``torch.profiler`` over 5
    calls, each pass's mean over the launches it recorded.  The bound counts 14 f32 operations per state element and step
    (S recomputed: 3, G stepped: 3, dr, dk, dv and dw: 2 each) against the
    f32 peak, over r, k, v, w, do and u read once and dr, dk, dv, dw and du
    written once.  No single PyTorch call computes the function."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6_bwd import checkpoint_bytes, wkv6_bwd

    B, H, S, N = K4_SHAPE
    ins = wkv6_bwd_inputs(B, H, S, N, gen, "bshn", "sigmoid", False)
    f32 = 4
    nbytes = (9 * B * H * S * N + 2 * H * N) * f32
    bnd = bound(14.0 * B * H * S * N * N, nbytes, peaks["f32"], peaks["bytes"])
    ms = time_ms(lambda: wkv6_bwd(*ins), batches=5, per_batch=5)
    plain = time_ms(lambda: ref.wkv6_bwd(*ins), batches=3, per_batch=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            wkv6_bwd(*ins)
        torch.cuda.synchronize()
    # each pass's mean over the launches the profiler recorded (a process
    # that profiles more than once may not record all of them)
    total, seen = {}, {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and (m := re.search(r"wkv6_bwd_(ckpt|main|du)", e.name))):
            total[m.group(1)] = total.get(m.group(1), 0.0) + e.time_range.elapsed_us() / 1e3
            seen[m.group(1)] = seen.get(m.group(1), 0) + 1
    split = {k: t / seen[k] for k, t in total.items()}
    del ins
    torch.cuda.empty_cache()
    return (ms, plain, None), bnd, split, checkpoint_bytes(B, H, S, N)


def time_flash(flash, ref, gen, peaks, shape, causal: bool = True, sq: int | None = None,
               cap: float = 0.0) -> tuple[tuple, tuple]:
    """-> ((ms, plain ms, SDPA ms), bound) of K3 in bf16 at ``shape`` (B, H,
    K, S, hd) on the model's strided views: ``sq`` queries (default S) over
    S keys, causal or not, with a logit cap where ``cap > 0`` (Sq = S).  A
    capped kernel's bound is the larger of the tensor bound and its
    special-function floor: 3 MUFU operations a kept pair (ex2 and rcp for
    a tanh accurate to the checks' tolerances, ex2 for P) at
    ``peaks["mufu"]``; its library call :func:`flex_capped`, whose output
    is first held against K3's at K3's bf16 tolerance."""
    import torch.nn.functional as F

    B, H, K, S, hd = shape
    Sq = S if sq is None else sq
    q = _strided((B, Sq, H, hd), torch.bfloat16, gen)
    k = _strided((B, S, K, hd), torch.bfloat16, gen)
    v = _strided((B, S, K, hd), torch.bfloat16, gen)
    # (query, key) pairs the mask keeps, each 4 hd operations at the
    # caller's head dim (not the padded one)
    pairs = B * H * Sq * (S + 1) / 2 if causal else B * H * Sq * S
    bf16 = 2
    bnd = bound(4.0 * pairs * hd, (2 * B * H * Sq * hd + 2 * B * K * S * hd) * bf16,
                peaks["bf16"], peaks["bytes"])
    ms = time_ms(lambda: flash(q, k, v, causal=causal, cap=cap))
    plain = time_ms(lambda: ref.flash_attention(q, k, v, causal=causal, cap=cap), batches=3,
                    per_batch=5)
    if cap:
        bnd = max(bnd, (3.0 * pairs / peaks["mufu"] * 1e3, "operations"))
        fn, args = flex_capped(q, k, v, cap, causal)
        torch.testing.assert_close(fn(*args).float(), flash(q, k, v, causal=causal, cap=cap)
                                   .float(), rtol=2e-2, atol=2e-2)
        return (ms, plain, time_ms(lambda: fn(*args))), bnd
    # the library call: SDPA, where its top-left causal alignment is the
    # reference's (Sq = Sk, or no mask), K and V expanded to the query heads
    # outside the timed call
    ke, ve = (t.repeat_interleave(H // K, dim=1) for t in (k, v))
    return (ms, plain, time_ms(lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                                      is_causal=causal))), bnd


def time_flash_f32(gen, peaks) -> tuple[dict, dict, dict]:
    """-> ({name: (ms, plain ms, library ms)}, {name: bound}, {name: max abs
    err}) of K3 (``flash_attention+f32``) and K3b (``flash_attention_bwd+f32``)
    on their f32 paths, on the CUDA cores, at lm-100m's training shape
    (``examples/train_lm_torch.py``: 4 x 128 tokens, 12 query heads over 4
    KV heads of 64, causal), on the model's strided views.  Each is first
    held against its plain version: K3 within 2e-5, K3b within 1e-4 x max
    |plain| a gradient.  The bounds: K3 4 hd and K3b 10 hd operations a kept
    pair at the f32 peak, over q, k, v, o (and dout, the LSE, dq, dk, dv)
    read or written once in f32; the library calls SDPA in f32
    (``is_causal``, K and V expanded to the query heads outside the timed
    call) and ``torch.autograd.grad`` through it, the backward alone."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_fwd
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    B, H, K, S, hd = LM100M_K3
    q, dout = (_strided((B, S, H, hd), torch.float32, gen) for _ in range(2))
    k, v = (_strided((B, S, K, hd), torch.float32, gen) for _ in range(2))
    pairs = B * H * S * (S + 1) / 2
    f32 = 4
    errs = {"flash_attention+f32": (flash_attention(q, k, v) - ref.flash_attention(q, k, v))
            .abs().max().item()}
    if not errs["flash_attention+f32"] <= 2e-5:
        raise AssertionError(f"K3 f32 at {LM100M_K3}: off its plain version by "
                             f"{errs['flash_attention+f32']}")
    o, lse = flash_attention_fwd(q, k, v)
    grads = flash_attention_bwd(q, k, v, o, lse, dout)
    errs["flash_attention_bwd+f32"] = 0.0
    for name, got, want in zip(("dq", "dk", "dv"), grads,
                               ref.flash_attention_bwd(q, k, v, o, lse, dout)):
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        if not err <= 1e-4 * scale:
            raise AssertionError(f"K3b f32 {name} at {LM100M_K3}: off by {err} (max {scale})")
        errs["flash_attention_bwd+f32"] = max(errs["flash_attention_bwd+f32"], err)
    bounds = {
        "flash_attention+f32": bound(4.0 * pairs * hd, (2 * B * H * S * hd + 2 * B * K * S * hd)
                                     * f32, peaks["f32"], peaks["bytes"]),
        "flash_attention_bwd+f32": bound(10.0 * pairs * hd, (4 * B * H * S * hd
                                                             + 4 * B * K * S * hd) * f32
                                         + B * H * S * 4, peaks["f32"], peaks["bytes"]),
    }
    ke, ve = (t.repeat_interleave(H // K, dim=1) for t in (k, v))
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, ke, ve))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    times = {
        "flash_attention+f32": (
            time_ms(lambda: flash_attention(q, k, v)),
            time_ms(lambda: ref.flash_attention(q, k, v), batches=3, per_batch=5),
            time_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True))),
        "flash_attention_bwd+f32": (
            time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout)),
            time_ms(lambda: ref.flash_attention_bwd(q, k, v, o, lse, dout), batches=3,
                    per_batch=5),
            time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True))),
    }
    return times, bounds, errs


def time_attention_and_wkv6(flash, wkv6, ref, gen, peaks) -> tuple[dict, dict]:
    """-> ({kernel: (ms, plain ms, library ms or None)}, {kernel: bound}) at
    the main paths' shapes (K3 at granite-3-2b's)."""
    t, bnd = time_flash(flash, ref, gen, peaks, K3_SHAPE)
    times, bounds = {"flash_attention": t}, {"flash_attention": bnd}

    B, H, S, N = K4_SHAPE
    r, kk, vv, w, u = wkv6_inputs(B, H, S, N, gen)
    f32 = 4
    # r, k, v, w read and o written, plus u read and the final state written.
    # The least work per step: the bonus term factors out, o_t = r_t^T S +
    # (sum_i r_i u_i k_i) v_t, so r^T S is 2 operations per state element and
    # the update w S + k v^T 3 more; the factored term is 5 per column
    # (r u k summed over i, then scaled by v and added to o)
    nbytes = (5 * B * H * S * N + H * N + B * H * N * N) * f32
    flops = 5.0 * B * H * S * (N * N + N)
    bounds["wkv6"] = bound(flops, nbytes, peaks["f32"], peaks["bytes"])
    times["wkv6"] = (time_ms(lambda: wkv6(r, kk, vv, w, u)),
                     time_ms(lambda: ref.wkv6(r, kk, vv, w, u), batches=3, per_batch=1),
                     None)  # no single PyTorch call computes the recurrence
    return times, bounds


def _chain_graph(n: int, nbytes: int):
    """tests/test_superstep.py's single chain: ``n`` matadds on group g0."""
    from repro_torch.core.graph import TaskGraph

    g = TaskGraph()
    for i in range(n):
        g.add(f"k{i}", op="matadd", costs={"g0": 1.0}, out_bytes=nbytes)
        if i:
            g.add_edge(f"k{i - 1}", f"k{i}", nbytes=nbytes)
    g.validate()
    return g, {f"k{i}": "g0" for i in range(n)}


def _diamond_graph(nbytes: int):
    """tests/test_superstep.py's diamond: a (matmul) fans out to two
    group-split branches that re-join."""
    from repro_torch.core.graph import TaskGraph

    g = TaskGraph()
    g.add("a", op="matmul", costs={"g0": 1.0}, out_bytes=nbytes)
    g.add("b", op="matadd", costs={"g0": 1.0}, out_bytes=nbytes)
    g.add("c", op="matmul", costs={"g1": 1.0}, out_bytes=nbytes)
    g.add("d", op="matadd", costs={"g0": 1.0, "g1": 1.0}, out_bytes=nbytes)
    for e in [("a", "b"), ("a", "c"), ("b", "d"), ("c", "d")]:
        g.add_edge(*e, nbytes=nbytes)
    g.validate()
    return g, {"a": "g0", "b": "g0", "c": "g1", "d": "g0"}


def _typed_chain_graph(B: int, H: int, S: int, N: int):
    """tests/test_superstep.py's typed chain: K3 at head_dim N over a packed
    q/k/v, K4 at head size N on its output, a reshape to a matrix.  The
    port's ``ops.wkv6`` returns ``(o, state)``: the chain takes ``[0]``."""
    from repro_torch.core.graph import TaskGraph
    from repro_torch.kernels import ops

    def attn(x):
        return ops.flash_attention(x[0], x[1], x[2], causal=True)

    def wkv(y):
        u = torch.full((H, N), 0.5, dtype=y.dtype, device=y.device)
        return ops.wkv6(torch.tanh(y), y, y, torch.sigmoid(y), u)[0]

    fns = {"attn": attn, "wkv": wkv, "squash": lambda z: z.reshape(B * H * S, N)}
    g = TaskGraph()
    for name, op in (("qkv", "attn"), ("mix", "wkv"), ("out", "squash")):
        g.add(name, op=op, costs={"g0": 1.0}, out_bytes=B * H * S * N * 4)
        g.nodes[name].fn = fns[op]
    g.add_edge("qkv", "mix", nbytes=B * H * S * N * 4)
    g.add_edge("mix", "out", nbytes=B * H * S * N * 4)
    g.validate()
    return g, {n: "g0" for n in g.nodes}


def check_fused(dev, modules: dict, smi: str) -> None:
    """``[fused]``: on the card at side 2048, the single chain and the diamond
    of tests/test_superstep.py and the typed K3 -> K4 chain run fused (one
    CUDA graph per group-step), serialized and in async waves, twice
    through one cache (captures, then replays of cached graphs): every
    output bit-equal to the unfused run's, every kernel counted once per
    execution through the replays.  Then one captured chain replayed twice
    with the first outputs still held: they must not change."""
    from repro_torch.core.executor import SuperStepCache, TorchExecutor, attach_matrix_kernels
    from repro_torch.kernels import graphs, ops

    def reset():
        for m in modules.values():
            m.reset_launches()

    nbytes = SIDE * SIDE * 4
    B, H, S, N = 2, 4, 1024, 4
    x = torch.randn((3, B, H, S, N), generator=torch.Generator().manual_seed(7))
    cases = [("single chain of 6 matadds", *_chain_graph(6, nbytes), None),
             ("diamond matmul/matadd on 2 groups", *_diamond_graph(nbytes), None),
             (f"typed K3->K4 chain (B{B} H{H} S{S} head_dim {N})",
              *_typed_chain_graph(B, H, S, N), {"qkv/in": x})]
    for label, g, asg, inputs in cases:
        if inputs is None:  # entries of std 1/sqrt(side) keep matmul chains in scale
            inputs = {k: v / math.sqrt(SIDE) for k, v in attach_matrix_kernels(g, SIDE).items()}
        ops_of = {}
        for n in g.nodes.values():
            ops_of[n.op] = ops_of.get(n.op, 0) + 1
        ex = TorchExecutor({grp: dev for grp in set(asg.values())})
        reset()
        unfused = ex.run(g, asg, inputs).outputs
        torch.cuda.synchronize()
        want_launches = {k: getattr(m, k).launches for k, m in modules.items()}
        cpu = TorchExecutor({grp: torch.device("cpu") for grp in set(asg.values())}).run(
            g, asg, inputs).outputs
        for name, t in unfused.items():
            scale = max(1.0, cpu[name].abs().max().item())
            torch.testing.assert_close(t.cpu(), cpu[name], rtol=1e-4, atol=1e-5 * scale)
        for async_groups in (False, True):
            cache = SuperStepCache()
            for rnd in range(2):
                reset()
                s = ex.session(g, asg, inputs, time_kernels=True, fused=True,
                               async_groups=async_groups, cache=cache)
                s.run_all()
                res = s.result()
                got = {k: getattr(m, k).launches for k, m in modules.items()}
                if got != want_launches:
                    raise AssertionError(f"[fused] {label}: launches through replays {got}, "
                                         f"unfused {want_launches}")
                for name, t in unfused.items():
                    if not torch.equal(res.outputs[name], t):
                        raise AssertionError(f"[fused] {label} async={async_groups}: {name} "
                                             f"differs from the unfused run")
                by_path = {k: {p: n for p, n in getattr(m, k).launches_by_path.items() if n}
                           for k, m in modules.items() if getattr(m, k).launches}
                print(f"[fused] {label} async_groups={async_groups} round {rnd}: "
                      f"fused_steps={res.fused_steps} waves={res.n_waves} "
                      f"hits={res.cache_hits} misses={res.cache_misses} static copies "
                      f"{res.static_copies} ({res.static_copy_bytes} bytes); launches by path "
                      f"{by_path} == unfused; outputs bit-equal to unfused ok")
            cache.clear()
    # a replay overwrites the graph's static outputs: what an earlier replay
    # handed out must be a fresh tensor that does not change
    gen = torch.Generator(device=dev).manual_seed(3)
    x1, x2 = (torch.randn(SIDE, SIDE, device=dev, generator=gen) / math.sqrt(SIDE)
              for _ in range(2))
    chain = ops.build_chain([(lambda a: ops.matadd(a, a), [("ext", 0)]),
                             (lambda a: ops.matmul(a, a.T), [("mem", 0)])], keep=[1])
    reset()
    entry = graphs.CapturedChain(chain, [x1], dev)
    first = entry.replay([x1])[0]
    torch.cuda.synchronize()
    held = first.clone()
    second = entry.replay([x2])[0]
    torch.cuda.synchronize()
    counts = {k: getattr(m, k).launches for k, m in modules.items() if getattr(m, k).launches}
    eager = chain(x2)[0]
    if not torch.equal(first, held) or torch.equal(first, second):
        raise AssertionError("[fused] a second replay changed the first replay's outputs")
    if not torch.equal(second, eager) or not torch.equal(first, chain(x1)[0]):
        raise AssertionError("[fused] replayed outputs differ from the eager chain's")
    if counts != {"matmul": 2, "matadd": 2}:
        raise AssertionError(f"[fused] capture + 2 replays counted {counts}, want 2 each")
    entry.release()
    print(f"[fused] one graph replayed twice (side {SIDE}): first outputs unchanged by the "
          f"second replay, both bit-equal to the eager chain; launches {counts} "
          f"(the capture's taken back) ok; {smi}")


def _fused_counts(d: dict) -> dict:
    return {k: d[k] for k in ("fused_steps", "waves", "cache_hits", "cache_misses",
                              "transfers", "kernels")}


class StepClock:
    """Stands in for the ``time`` module of the executor: every
    ``perf_counter`` reading advances by ``dt`` seconds, so each timed
    group-step or wave measures the same on the card and on the CPU."""

    def __init__(self, dt: float = 1e-4):
        self.t, self.dt = 0.0, dt

    def perf_counter(self) -> float:
        self.t += self.dt
        return self.t


def arena_fused(dev, modules: dict, smi: str) -> tuple[dict, dict]:
    """``[arena-fused]``: the CI stream at side 2048 on the card under each
    of the five policies, fused, then fused with async waves; each policy
    run on its own (counters set to 0 and peak memory reset just before,
    the captured graphs released at its end).  -> ({kernel: launches by
    path} summed over the runs, {mode: (wall ms, launches by kernel)}).

    The stream's arrivals and its drop land on the measured clock, so those
    runs' counters follow the card's kernel times.  Each mode then runs the
    stream once more per policy under a step clock, on the card and on the
    CPU, both at side 2048 (the blocks' bytes set the pulls' virtual times,
    so the side changes the plans): there the fused steps, waves, hits,
    misses and transfers must be equal."""
    from repro_torch.core import executor as tex
    from repro_torch.core.arena import make_request_stream
    from repro_torch.launch.serve import EXECUTED_POLICIES, run_arena_executed

    cpu = torch.device("cpu")
    stream_nodes = sum(s.graph.num_nodes() for s in make_request_stream(
        STREAM["steps"], base_requests=STREAM["n_requests"],
        decode_chunks=STREAM["decode_chunks"], seed=STREAM["seed"]))

    def run(policy, device, async_groups):
        return run_arena_executed(
            STREAM["n_requests"], STREAM["decode_chunks"], steps=STREAM["steps"],
            drop_step=STREAM["drop_step"], seed=STREAM["seed"], side=SIDE, device=device,
            fused=True, async_groups=async_groups, policies=(policy,))[1].reports[policy]

    totals: dict = {k: dict.fromkeys(m.PATHS, 0) for k, m in modules.items()}
    walls: dict = {}
    for async_groups in (False, True):
        mode = "fused, async waves" if async_groups else "fused"
        walls[mode] = (0.0, {"matmul": 0, "matadd": 0})
        for policy in EXECUTED_POLICIES:
            for m in modules.values():
                m.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            d = run(policy, dev, async_groups).to_dict()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            ran = d["kernels_by_op"]
            launches = {k: getattr(modules[k], k).launches for k in ("matmul", "matadd")}
            if (launches["matmul"] != ran.get("prefill", 0)
                    or launches["matadd"] != ran.get("decode", 0) or not all(launches.values())):
                raise AssertionError(f"[arena-fused] {policy} {mode}: launches through replays "
                                     f"{launches} != executed {ran}")
            mm_by_path = modules["matmul"].matmul.launches_by_path
            if mm_by_path["wgmma"] != launches["matmul"]:
                raise AssertionError(f"[arena-fused] {policy}: matmul by path {mm_by_path}")
            if (d["kernels"] < stream_nodes or d["steps"] != STREAM["steps"]
                    or d["cache_hits"] + d["cache_misses"] != d["fused_steps"]
                    or not 0 < d["waves"] <= d["fused_steps"] or d["static_copies"] == 0):
                raise AssertionError(f"[arena-fused] {policy} {mode}: {_fused_counts(d)}, "
                                     f"static copies {d['static_copies']}")
            for k, m in modules.items():
                for p, n in getattr(m, k).launches_by_path.items():
                    totals[k][p] += n
            walls[mode] = (walls[mode][0] + wall,
                           {k: walls[mode][1][k] + n for k, n in launches.items()})
            print(f"[arena-fused] {policy} ({mode}): wall_ms={wall:.1f} "
                  f"total_makespan_ms={d['total_makespan_ms']:.3f} {_fused_counts(d)} "
                  f"static copies {d['static_copies']} "
                  f"({d['static_copy_bytes'] / 2**20:.0f} MiB); launches {launches} == "
                  f"executed {ran}; peak memory {peak_gb:.2f} GB; {smi}")
            gc.collect()
            torch.cuda.empty_cache()
        # the same stream under one step clock: the card's counters == the CPU's
        saved = tex.time
        try:
            for policy in EXECUTED_POLICIES:
                got = {}
                for device in (dev, cpu):
                    tex.time = StepClock()
                    got[device.type] = _fused_counts(run(policy, device,
                                                         async_groups).to_dict())
                if got["cuda"] != got["cpu"]:
                    raise AssertionError(f"[arena-fused] {policy} ({mode}) on a step clock: "
                                         f"card {got['cuda']} != CPU {got['cpu']}")
                print(f"[arena-fused] {policy} ({mode}) on a step clock, side {SIDE}: "
                      f"card {got['cuda']} == CPU ok")
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            tex.time = saved
    return totals, walls


def sharpen_attention(tree: dict, gain: float) -> None:
    """Scales the query and key projections (``wq``, ``wk``) of every
    attention in a parameter tree by ``gain``, in place."""
    if "wq" in tree and "wk" in tree:
        tree["wq"].mul_(gain)
        tree["wk"].mul_(gain)
    for v in tree.values():
        if isinstance(v, dict):
            sharpen_attention(v, gain)


def card_vs_cpu(arch: str, dev) -> None:
    """2 layers of ``arch`` at full width in f32 (and 2 encoder layers for
    the encoder-decoder; jamba's layers 0 and 4, a Mamba and the attention
    layer), batch 2, a prompt of 128 text positions (after the VLM's 576
    patches), 4 decode steps: the same parameters (drawn on the card, where
    drawing is fast, and copied to the CPU) on the card and on the CPU.
    Tolerance: rtol 1e-4 and atol 1e-4 x the largest CPU logit (f32
    products of K up to 24576 summed in another order on each side).  An
    ``arch+variant`` takes the variant's fields at a cut's values
    (``split_variant(cut=True)``) and its queries and keys ``CUT_QK_GAIN``
    times as large, and its card logits must differ from those of the same
    cut without its attention cap by over 100 times the tolerance."""
    from repro_torch.configs.registry import get_config, make_batch, split_variant
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params, tree_map

    full = get_config(arch)
    unit = tuple(full.unit[i] for i in CARD_VS_CPU_UNIT.get(arch, range(len(full.unit))))
    cfg = dataclasses.replace(full, n_layers=2, unit=unit, activation_dtype="float32",
                              n_encoder_layers=2 if full.enc_dec else 0,
                              **split_variant(arch, cut=True)[1])
    ctx = Ctx(dtype=torch.float32)
    B, S, steps = 2, 128 + (cfg.n_patches if cfg.vlm else 0), 4
    with torch.inference_mode():
        params = init_params(T.model_param_specs(cfg), torch.Generator(dev).manual_seed(0))
        if cfg.attn_logit_softcap:
            sharpen_attention(params, CUT_QK_GAIN)
        batch = make_batch(cfg, S, B, train=False, generator=torch.Generator().manual_seed(0))
        sides = {"cpu": (tree_map(lambda t: t.cpu(), params), batch),
                 "card": (params, {k: t.to(dev) for k, t in batch.items()})}
        caches, logits = {}, {}
        for side, (p, b) in sides.items():
            caches[side], logits[side] = T.prefill(p, b, cfg, ctx, cache_len=S + steps)
        moved = ""
        if cfg.attn_logit_softcap:
            _, free = T.prefill(*sides["card"], dataclasses.replace(cfg, attn_logit_softcap=0.0),
                                ctx, cache_len=S + steps)
            want = logits["cpu"]
            diff = (free.cpu() - want).abs().max().item()
            if not diff > 100 * 1e-4 * want.abs().max().item():
                raise AssertionError(f"[card-vs-cpu] {cfg.name}: the attention cap "
                                     f"{cfg.attn_logit_softcap:g} moves the logits by {diff} only")
            moved = (f"; without the attention cap {cfg.attn_logit_softcap:g} the card's prefill "
                     f"logits move by {diff:.4g} (> 100 x the tolerance)")
            del free
        errs = []
        for i in range(steps + 1):
            want, got = logits["cpu"], logits["card"].cpu()
            scale = want.abs().max().item()
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
            errs.append((got - want).abs().max().item())
            if i == steps:
                break
            tok = want.argmax(-1)
            for side, (p, _) in sides.items():
                logits[side], caches[side] = T.decode_step(
                    p, caches[side], tok.to(p["embed"].device), S + i, cfg, ctx)
    layers = ("2 layers" + (" (and 2 encoder layers)" if cfg.enc_dec else "")
              + (f" ({', '.join(f'{s.mixer}+{s.ffn}' for s in unit)})"
                 if arch in CARD_VS_CPU_UNIT else ""))
    caps = (f" (caps {cfg.attn_logit_softcap:g} and {cfg.logits_softcap:g}, a cut's; queries "
            f"and keys x{CUT_QK_GAIN:g})" if cfg.attn_logit_softcap else "")
    print(f"[card-vs-cpu] {cfg.name}{caps} {layers} full width f32 B{B} S{S}: prefill logits "
          f"max_abs_err={errs[0]}, decode steps {errs[1:]} (rtol=1e-4, atol=1e-4 x "
          f"max|logit|){moved} ok")


def served_config(arch: str, cut: dict):
    """The published config of ``arch`` (or of ``arch+variant``) with its one
    listed cut, if any: fewer layers, and for a ``unit`` slice only those
    layers of the unit."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    if "unit" in cut:
        cut = dict(cut, unit=cfg.unit[cut["unit"]])
    return dataclasses.replace(cfg, **cut)


def expected_launches(cfg, kname: str, decode_len: int) -> tuple[int, str]:
    """-> (launches, path) of the prefill kernel ``kname`` in one
    ``serve_smoke`` of ``cfg``: one per attention (or RWKV-6) layer of the
    prefill; for the encoder-decoder also one per encoder layer and one
    cross-attention per decoder layer, in the prefill and then in each
    decode step (the warm-up before the capture, which runs eagerly, and
    each of the ``decode_len`` replays, counted through them as the fused
    path counts).  K3 pads a head dim that is not built (MLA's 96)."""
    if kname == "wkv6":
        return cfg.n_layers, "ring"
    from repro_torch.kernels.flash_attention import built_head_dim

    n = cfg.attn_layer_count()
    if cfg.enc_dec:
        n += cfg.n_encoder_layers + cfg.n_layers * (1 + 1 + decode_len)
    return n, "tma" if built_head_dim(cfg.hd) == cfg.hd else "pad"


def init_in_dtype(cfg, dev) -> None:
    """``[init]``: the weights as ``serve_smoke`` draws them, each leaf cast
    to bf16 as it is drawn (``init_params(..., dtype)``), against the f32
    tree drawn whole and cast afterwards (``cast_params``), both from seed 0
    on the card: every leaf bit-equal, so drawing in bf16 changes no served
    token.  Run where both trees fit the card."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import cast_params, init_params, tree_leaves

    specs = T.model_param_specs(cfg)
    with torch.inference_mode():
        got = tree_leaves(init_params(specs, torch.Generator(dev).manual_seed(0),
                                      torch.bfloat16))
        want = tree_leaves(cast_params(init_params(specs, torch.Generator(dev).manual_seed(0)),
                                       torch.bfloat16))
        same = sum(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    if same != len(want) or len(got) != len(want):
        raise AssertionError(f"[init] {cfg.name}: {same} of {len(want)} leaves bit-equal")
    print(f"[init] {cfg.name} full width, {cfg.n_layers} layers: the {len(got)} leaves drawn "
          f"in bf16 bit-equal to the f32 tree cast afterwards")


def serve_full_width(cfg, kname: str, prompt_len: int, n_requests: int, dev, smi: str
                     ) -> dict:
    """``serve_smoke`` on ``cfg`` at full width (bf16 activations),
    ``n_requests`` requests of ``prompt_len`` positions and 32 decode tokens,
    the counters of the kernel ``kname`` set to 0 just before; -> what the
    run printed.  The launches and their path must be
    :func:`expected_launches`', and K3's all capped for a config with an
    attention logit cap, none otherwise (its prefill launches them all
    through the wrapper)."""
    from repro_torch.launch.serve import serve_smoke

    module = importlib.import_module(f"repro_torch.kernels.{kname}")
    kernel = getattr(module, kname)
    serve = dict(SERVE, prompt_len=prompt_len, n_requests=n_requests)
    torch.cuda.reset_peak_memory_stats()
    module.reset_launches()
    tokens, stats = serve_smoke(cfg, **serve, seed=0, device=dev)
    launches = kernel.launches
    by_path = dict(kernel.launches_by_path)
    capped = getattr(kernel, "launches_capped", 0)
    want, path = expected_launches(cfg, kname, serve["decode_len"])
    if capped != (launches if cfg.attn_logit_softcap else 0):
        raise AssertionError(f"{cfg.name}: {capped} of {kname}'s {launches} launches capped, "
                             f"attn_logit_softcap {cfg.attn_logit_softcap}")
    if not stats.logits_finite:
        raise AssertionError(f"{cfg.name}: non-finite logits")
    if tuple(tokens.shape) != (serve["n_requests"], serve["decode_len"] + 1):
        raise AssertionError(f"{cfg.name}: tokens {tuple(tokens.shape)}")
    if launches != want or by_path[path] != launches:
        raise AssertionError(f"{cfg.name}: {kname} launched {launches} times (by path "
                             f"{by_path}), not {want}, all on {path}")
    if not stats.capture_ms > 0:
        raise AssertionError(f"{cfg.name}: serve_smoke on the card captured no decode graph")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shape = (f"{serve['n_requests']} requests x {prompt_len}-position prompts"
             + (f" ({cfg.n_patches} patches + {prompt_len - cfg.n_patches} text tokens)"
                if cfg.vlm else "")
             + (f" over {cfg.encoder_seq} encoder frames" if cfg.enc_dec else ""))
    print(f"[serve] {cfg.name} full width, {cfg.n_layers} layers, {shape}, "
          f"{serve['decode_len']} decode tokens, bf16: prefill {stats.prefill_ms:.1f} ms, "
          f"decode {stats.decode_ms_per_token:.2f} ms/token through one CUDA graph per step "
          f"(captured in {stats.capture_ms:.1f} ms), {stats.tokens_per_s:.1f} tokens/s; "
          f"{kernel.__name__} launches {launches} == expected {want}, all on {path} (by path "
          f"{by_path}), {capped} capped; peak memory {peak_gb:.1f} GB; tokens sha256 "
          f"{hashlib.sha256(tokens.numpy().tobytes()).hexdigest()[:16]}; {smi}")
    return {"launches": launches, "prefill_ms": stats.prefill_ms, "by_path": by_path,
            "capped": capped}


def _kernel_ms(prof) -> tuple[dict[str, float], int]:
    """-> ({kernel name: ms on the device}, kernels launched) of a
    ``torch.profiler`` run."""
    by_name: dict[str, float] = {}
    launched = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            launched += 1
    return by_name, launched


def _top(by_name: dict[str, float], n: int = 5) -> str:
    return "; ".join(f"{name[:60]} {t:.1f} ms"
                     for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:n])


def profile_serving(cfg, prompt_len: int, n_requests: int, dev, kernel_key: str,
                    steps: int = 4) -> None:
    """One prefill and ``steps`` decode steps of the full-width ``cfg`` (the
    serving shapes, fresh weights from seed 0) under ``torch.profiler``:
    the device kernel time against the wall of the same span, the kernels
    that take most of it, and the share of the port's kernels whose names
    hold ``kernel_key``.  Profiling inflates the wall; the unprofiled times
    are the ``[serve]`` line's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params

    ctx = Ctx(dtype=torch.bfloat16)
    B, S = n_requests, prompt_len
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    spans = {}
    with torch.inference_mode():
        gen = torch.Generator(dev).manual_seed(0)
        params = init_params(T.model_param_specs(cfg), gen, ctx.dtype)
        batch = make_batch(cfg, S, B, train=False, generator=gen)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            cache, logits = T.prefill(params, batch, cfg, ctx, cache_len=S + steps)
            torch.cuda.synchronize()
            spans["prefill"] = (prof, (time.perf_counter() - t0) * 1e3)
        tok = logits.argmax(-1)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, cache = T.decode_step(params, cache, tok, S + i, cfg, ctx)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            spans[f"{steps} decode steps"] = (prof, (time.perf_counter() - t0) * 1e3)
    for span, (prof, wall_ms) in spans.items():
        by_name, launched = _kernel_ms(prof)
        busy = sum(by_name.values())
        mine = sum(t for name, t in by_name.items() if kernel_key in name)
        print(f"[profile] {cfg.name} {span}: {launched} kernels, {busy:.1f} ms on the device in "
              f"{wall_ms:.1f} ms of wall under the profiler (device busy "
              f"{busy / wall_ms:.1%}); {kernel_key} kernels {mine:.1f} ms "
              f"({mine / busy:.1%} of the device time); top: {_top(by_name)}")


def prefill_split(cfg, prompt_len: int, n_requests: int, dev, smi: str) -> None:
    """``[prefill-split]``: where one prefill of the full-width ``cfg`` (a
    decoder-only stack; fresh weights from seed 0) goes.  One whole prefill
    is timed after a warm-up one; then each layer's mixer and FFN (each
    after its norm, on the previous layer's output, as in the prefill),
    summed by kind; then, for a Mamba model, the recurrence alone
    (``ssm.scan`` on f32 inputs of the served shape).  Host clock, each span
    ended by a device synchronise: the Mamba scan's small launches are paced
    by the host, so device time alone would miss its cost."""
    from repro_torch.configs.registry import make_batch
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params

    ctx = Ctx(dtype=torch.bfloat16)
    B, S = n_requests, prompt_len
    spans: dict[str, list[float]] = {}

    def timed(kind, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        spans.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.inference_mode():
        gen = torch.Generator(dev).manual_seed(0)
        params = init_params(T.model_param_specs(cfg), gen, ctx.dtype)
        batch = make_batch(cfg, S, B, train=False, generator=gen)
        T.prefill(params, batch, cfg, ctx)
        timed("prefill", lambda: T.prefill(params, batch, cfg, ctx))
        x = T.embed_tokens(params, batch["tokens"], cfg, ctx)
        positions = torch.arange(S, device=dev)
        for u in range(cfg.n_units):
            unit_p = T._unit(params["unit"], u)
            for i, spec in enumerate(cfg.unit):
                p = unit_p[f"l{i}"]
                x = x + timed(f"{spec.mixer} mixer", lambda: T._mixer_full(
                    spec, p, L.rmsnorm(p["mixer_norm"], x, cfg.norm_eps), cfg, ctx,
                    positions, True)[0])
                x = x + timed(f"{spec.ffn} ffn", lambda: T._ffn(
                    spec, p, L.rmsnorm(p["ffn_norm"], x, cfg.norm_eps), cfg, ctx)[0])
        del x
        if any(spec.mixer == "mamba" for spec in cfg.unit):
            di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
            xf, dt = (torch.randn(B, S, di, device=dev, generator=gen) for _ in range(2))
            b, c = (torch.randn(B, S, ds, device=dev, generator=gen) for _ in range(2))
            A = -torch.ones(di, ds, device=dev)
            dt = torch.nn.functional.softplus(dt)
            ssm.scan(xf, dt, b, c, A, ctx)
            timed("mamba scan alone", lambda: ssm.scan(xf, dt, b, c, A, ctx))
    total = spans.pop("prefill")[0]
    parts = "; ".join(f"{kind} x{len(t)} {sum(t):.1f} ms ({sum(t) / total:.1%})"
                      for kind, t in sorted(spans.items(), key=lambda kv: -sum(kv[1])))
    print(f"[prefill-split] {cfg.name} full width, {cfg.n_layers} layers, {B} requests x "
          f"{S} positions, bf16: prefill {total:.1f} ms; {parts} (the scan alone is one "
          f"layer's, inside its mamba mixer); {smi}")


def decode_graph(cfg, prompt_len: int, n_requests: int, dev, smi: str) -> None:
    """``[decode-graph]``: the full-width ``cfg`` (``n_requests`` prompts of
    ``prompt_len`` positions, bf16,
    weights from seed 0) prefilled once, then 32 greedy decode steps from the
    same cache twice, timed back to back: the eager loop (``T.decode_step``
    called once per token, as ``profile_serving`` calls it) and
    ``DecodeGraph``'s replays (one captured CUDA graph per step, as
    ``serve_smoke`` runs it).  Greedy tokens must be equal; the logits
    bit-equal, or else within ``[card-vs-cpu]``'s tolerance (rtol 1e-4, atol
    1e-4 x the largest eager logit).  Each loop also keeps a clone of every
    step's logits, the same copy in both.  Then a second capture, replayed
    over the same 32 steps under ``torch.profiler``: device busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import make_batch
    from repro_torch.launch.serve import DecodeGraph
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params, tree_leaves, tree_map

    arch = cfg.name
    ctx = Ctx(dtype=torch.bfloat16)
    B, S, n = n_requests, prompt_len, SERVE["decode_len"]
    with torch.inference_mode():
        gen = torch.Generator(dev).manual_seed(0)
        params = init_params(T.model_param_specs(cfg), gen, ctx.dtype)
        batch = make_batch(cfg, S, B, train=False, generator=gen)
        cache, logits = T.prefill(params, batch, cfg, ctx, cache_len=S + n)
        tok0 = logits.argmax(-1)
        saved = tree_map(torch.clone, cache)

        def restore():
            for dst, src in zip(tree_leaves(cache), tree_leaves(saved)):
                dst.copy_(src)

        def loop(step):
            tok, toks, logs = tok0, [], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                logits = step(tok, i)
                logs.append(logits.clone())
                tok = logits.argmax(-1)
                toks.append(tok)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n, torch.stack(toks, 1), logs

        eager_ms, eager_toks, eager_logits = loop(
            lambda tok, i: T.decode_step(params, cache, tok, S + i, cfg, ctx)[0])
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = DecodeGraph(params, cache, tok0, S, cfg, ctx)
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        try:
            graph_ms, graph_toks, graph_logits = loop(lambda tok, i: graph(tok))
        finally:
            graph.release()
        if not torch.equal(graph_toks, eager_toks):
            raise AssertionError(f"[decode-graph] {arch}: greedy tokens through the graph "
                                 f"differ from eager at {(graph_toks != eager_toks).sum()} places")
        err = max((g - e).abs().max().item() for g, e in zip(graph_logits, eager_logits))
        bit_equal = all(torch.equal(g, e) for g, e in zip(graph_logits, eager_logits))
        if not bit_equal:
            for g, e in zip(graph_logits, eager_logits):
                torch.testing.assert_close(g, e, rtol=1e-4, atol=1e-4 * e.abs().max().item())
        if not all(torch.isfinite(x).all() for x in graph_logits):
            raise AssertionError(f"[decode-graph] {arch}: non-finite logits")
        del graph_logits, eager_logits
        # the graph's busy share: a fresh capture, its replays profiled
        restore()
        graph = DecodeGraph(params, cache, tok0, S, cfg, ctx)
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tok = tok0
                for _ in range(n):
                    tok = graph(tok).argmax(-1)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        finally:
            graph.release()
    by_name, launched = _kernel_ms(prof)
    busy = sum(by_name.values())
    share = f"{busy / wall:.1%}" if launched else "not measured (the profiler saw no kernel)"
    print(f"[decode-graph] {cfg.name} full width, {cfg.n_layers} layers, {B} requests x "
          f"{S}-position prompts, {n} decode "
          f"tokens, bf16: greedy tokens equal to eager; logits "
          f"{'bit-equal' if bit_equal else 'within rtol 1e-4, atol 1e-4 x max|logit|'} "
          f"(max_abs_err={err}); capture {capture_ms:.1f} ms (one warm-up step included); "
          f"decode graph {graph_ms:.2f} ms/token, eager {eager_ms:.2f} ms/token "
          f"({eager_ms / graph_ms:.2f}x); graph replays under the profiler: {launched} "
          f"kernels, {busy:.1f} ms on the device in {wall:.1f} ms of wall (device busy "
          f"{share}); top: {_top(by_name)}; {smi}")


class _CountedReplica:
    """An ``ExecutorReplica`` that keeps each step's report and the requests
    the router sent it (the router keeps neither)."""

    def __init__(self, replica):
        self.inner, self.name = replica, replica.name
        self.reports, self.routed = [], []

    def run_step(self, step):
        from repro_torch.core.arena import requests_of

        self.routed.append((step.tag, sorted(requests_of(step.graph))))
        rep = self.inner.run_step(step)
        self.reports.append(rep)
        return rep

    def residency(self):
        return self.inner.residency()

    def drain_kv(self):
        return self.inner.drain_kv()


TRAIN_ARCH = "granite_3_2b"  # [train-restart]'s
# the full-depth [train] runs: (arch, sequences x positions, steps); the
# capped granite (the registry's VARIANTS) takes 3 steps
TRAIN_RUNS = (("granite_3_2b", (8, 2048), 6), ("rwkv6_3b", (8, 2048), 6),
              ("granite_3_2b+softcap", (8, 2048), 3))
TRAIN_VS_CPU = ("granite_3_2b", "minicpm3_4b", "whisper_large_v3", "rwkv6_3b",
                "granite_3_2b+softcap")
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "wkv6", "wkv6_bwd")


def _counts() -> dict:
    """K3's, K3b's, K4's and K4b's launch counts by path."""
    from repro_torch.kernels import ops

    return {k: dict(ops.KERNELS[k].launches_by_path) for k in TRAIN_KERNELS}


def _reset_counts() -> None:
    from repro_torch.kernels import flash_attention, flash_attention_bwd, wkv6, wkv6_bwd

    for module in (flash_attention, flash_attention_bwd, wkv6, wkv6_bwd):
        module.reset_launches()


def _train_launches(cfg, steps: int) -> dict:
    """{kernel: (its path, launches)} of ``steps`` training steps of ``cfg``
    under remat: per attention layer K3 twice (the forward and the
    recompute) and K3b once, per RWKV-6 layer K4 twice and K4b once."""
    n_attn = cfg.attn_layer_count() + (cfg.n_layers + cfg.n_encoder_layers if cfg.enc_dec
                                       else 0)
    n_rwkv = sum(1 for spec in cfg.layer_specs() if spec.mixer == "rwkv6")
    return {"flash_attention": ("tma", 2 * n_attn * steps),
            "flash_attention_bwd": ("tma", n_attn * steps),
            "wkv6": ("ring", 2 * n_rwkv * steps), "wkv6_bwd": ("direct", n_rwkv * steps)}


def train_vs_cpu(arch: str, dev) -> None:
    """``[train-vs-cpu]``: one ``make_train_step`` step of a 2-layer,
    full-width cut of ``arch`` in f32 (and 2 encoder layers for the
    encoder-decoder), batch 2 x 128, on the card and on the CPU from the
    same parameters (drawn on the CPU) and batch.  The card's step must
    launch K3 twice per attention (the forward and the remat recompute) and
    K3b once, K4 twice per RWKV-6 layer and K4b once.  Tolerance: the loss
    and ``grad_norm`` at 1e-4 relative (f32
    sums taken in another order on each side); the updated parameters at
    1e-4 x the largest parameter, and the first moments (0.1 x the clipped
    gradient) at 1e-4 x the largest of them: scales of the whole tree, as
    some gradients are 0 up to rounding (a key bias shifts every logit of a
    row alike), and their elements' noise is all a leaf of them holds.  An
    ``arch+variant`` takes the variant's fields at a cut's values and its
    queries and keys ``CUT_QK_GAIN`` times as large, and its card's first
    moments must differ from those of a step without its attention cap by
    over 100 times their tolerance."""
    from repro_torch.configs.registry import get_config, make_batch, split_variant
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import init_params, tree_leaves, tree_map

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=2, activation_dtype="float32",
                              n_encoder_layers=2 if full.enc_dec else 0,
                              **split_variant(arch, cut=True)[1])
    step, p_specs, o_specs, _ = make_train_step(cfg)
    params = init_params(p_specs, torch.Generator().manual_seed(0))
    if cfg.attn_logit_softcap:
        sharpen_attention(params, CUT_QK_GAIN)
    opt = init_params(o_specs, torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 128, 2, train=True, generator=torch.Generator().manual_seed(1))
    card = (tree_map(lambda t: t.to(dev, copy=True), params),
            tree_map(lambda t: t.to(dev, copy=True), opt),
            {k: t.to(dev) for k, t in batch.items()})
    uncapped = (tree_map(lambda t: t.to(dev, copy=True), params),
                tree_map(lambda t: t.to(dev, copy=True), opt),
                card[2]) if cfg.attn_logit_softcap else None
    _reset_counts()
    p_card, o_card, m_card = step(*card)
    torch.cuda.synchronize()
    counts = _counts()
    p_cpu, o_cpu, m_cpu = step(params, opt, batch)
    want_launches = {k: n for k, (_, n) in _train_launches(cfg, 1).items()}
    got_launches = {k: sum(by.values()) for k, by in counts.items()}
    if got_launches != want_launches:
        raise AssertionError(f"[train-vs-cpu] {cfg.name}: launched {counts}, want "
                             f"{want_launches}")
    for key in ("loss", "grad_norm"):
        got, want = float(m_card[key]), float(m_cpu[key])
        if not abs(got - want) <= 1e-4 * abs(want):
            raise AssertionError(f"[train-vs-cpu] {cfg.name}: {key} card {got} CPU {want}")
    worst = {}
    for name, got, want in (("params", tree_leaves(p_card), tree_leaves(p_cpu)),
                            ("m", [mv["m"] for mv in _mv(o_card["moments"])],
                             [mv["m"] for mv in _mv(o_cpu["moments"])])):
        scale = max(w.abs().max().item() for w in want)
        err = max((g.cpu() - w).abs().max().item() for g, w in zip(got, want))
        if not err <= 1e-4 * scale:
            raise AssertionError(f"[train-vs-cpu] {cfg.name}: updated {name} off by {err} "
                                 f"(largest {scale})")
        worst[name] = err / scale
    if int(o_card["step"]) != 1:
        raise AssertionError(f"[train-vs-cpu] {cfg.name}: step {int(o_card['step'])}")
    moved = ""
    if uncapped is not None:
        free_step = make_train_step(dataclasses.replace(cfg, attn_logit_softcap=0.0))[0]
        _, o_free, m_free = free_step(*uncapped)
        want = [mv["m"] for mv in _mv(o_cpu["moments"])]
        scale = max(w.abs().max().item() for w in want)
        diff = max((a - b).abs().max().item() for a, b in
                   zip([mv["m"] for mv in _mv(o_free["moments"])],
                       [mv["m"] for mv in _mv(o_card["moments"])]))
        if not diff > 100 * 1e-4 * scale:
            raise AssertionError(f"[train-vs-cpu] {cfg.name}: the attention cap "
                                 f"{cfg.attn_logit_softcap:g} moves the first moments by {diff} "
                                 f"only (largest {scale})")
        moved = (f"; without the attention cap {cfg.attn_logit_softcap:g} the card's loss is "
                 f"{float(m_free['loss']):.7f} and its first moments move by "
                 f"{diff / scale:.3e} of their largest (> 1e-2)")
        del uncapped, o_free
    caps = (f" (caps {cfg.attn_logit_softcap:g} and {cfg.logits_softcap:g}, a cut's; queries "
            f"and keys x{CUT_QK_GAIN:g})" if cfg.attn_logit_softcap else "")
    layers = "2 layers" + (" (and 2 encoder layers)" if cfg.enc_dec else "")
    print(f"[train-vs-cpu] {cfg.name}{caps} {layers} full width f32 B2 S128: loss card "
          f"{float(m_card['loss']):.7f} CPU {float(m_cpu['loss']):.7f}, grad_norm card "
          f"{float(m_card['grad_norm']):.6f} CPU {float(m_cpu['grad_norm']):.6f} (rtol 1e-4); "
          f"updated params and first moments max_err / their largest "
          f"{worst['params']:.3e}, {worst['m']:.3e} (< 1e-4); K3 {counts['flash_attention']}, "
          f"K3b {counts['flash_attention_bwd']}, K4 {counts['wkv6']}, K4b {counts['wkv6_bwd']}"
          f"{moved} ok")


def _mv(moments) -> list:
    """The {"m", "v"} leaves of a moments tree, in the parameters' order."""
    if set(moments) == {"m", "v"}:
        return [moments]
    return [mv for k in sorted(moments) for mv in _mv(moments[k])]


def train_full(arch: str, batch: tuple[int, int], steps: int, dev, smi: str) -> dict:
    """``[train]``: ``arch`` at full width and depth (f32 parameters and
    AdamW state, bf16 activations, remat on), synthetic data, ``steps``
    steps of ``batch`` through ``repro_torch.launch.train.train``, the
    counters set to 0 just before: per layer and step, K3 (attention) or K4
    (RWKV-6) must have run twice (the forward and the remat recompute), on
    ``tma`` or ``ring``, and K3b or K4b once, on ``tma`` or ``direct``; every
    loss finite, the last below the first, and every parameter moved.  Then
    one more step under
    ``torch.profiler``.  -> {"counts": {kernel: launches by path},
    "capped": {kernel: capped launches}, "step_ms": median}.  K3's and K3b's
    launches must all be capped for a config with an attention logit cap,
    none otherwise."""
    import contextlib
    import io
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models.params import count_params, init_params, tree_leaves

    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    B, S = batch
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        params, opt, losses = train(cfg, steps=steps, global_batch=B, seq_len=S,
                                    log_every=1, seed=0, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    capped = {k: getattr(ops.KERNELS[k], "launches_capped", 0) for k in TRAIN_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(log.getvalue(), end="")
    step_ms = [float(m) for m in re.findall(r"\((\d+) ms/step\)", log.getvalue())]
    want = _train_launches(cfg, steps)
    for k, (path, count) in want.items():
        if sum(counts[k].values()) != count or counts[k][path] != count:
            raise AssertionError(f"[train] {cfg.name}: {k} launched {counts[k]}, want {count} "
                                 f"on {path} ({count // steps} a step)")
        if capped[k] != (count if cfg.attn_logit_softcap else 0):
            raise AssertionError(f"[train] {cfg.name}: {capped[k]} of {k}'s {count} launches "
                                 f"capped, attn_logit_softcap {cfg.attn_logit_softcap}")
    if (len(losses) != steps or not all(math.isfinite(x) for x in losses)
            or not losses[-1] < losses[0]):
        raise AssertionError(f"[train] {cfg.name}: losses {losses}, not finite and falling")
    init = init_params(make_train_step(cfg)[1], torch.Generator(device=dev).manual_seed(0))
    still = [tuple(a.shape) for a, b in zip(tree_leaves(params), tree_leaves(init))
             if torch.equal(a, b)]
    del init
    if still:
        raise AssertionError(f"[train] {cfg.name}: parameters that did not move: {still}")
    tokens = B * S
    steady = statistics.median(step_ms[1:])
    n_params = count_params(make_train_step(cfg)[1])
    ratio = 6 * n_params * tokens / (steady / 1e3) / 989e12
    # the kernels of this model's mixer: (forward, backward) as named in the JSON line
    fwd, bwd = ("wkv6", "wkv6_bwd") if want["wkv6"][1] else ("flash_attention",
                                                             "flash_attention_bwd")
    short = {"flash_attention": "K3", "flash_attention_bwd": "K3b", "wkv6": "K4",
             "wkv6_bwd": "K4b"}
    n = want[bwd][1] // steps
    print(f"[train] {cfg.name} full width and depth ({cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f}B params), f32 params and AdamW state, bf16 activations, "
          f"remat on, batch {B} x {S}, {steps} steps in {wall:.1f} s: losses "
          f"{[round(x, 4) for x in losses]}, ms/step {step_ms} (median of steps 2-"
          f"{steps} {steady:.0f}), {tokens / (steady / 1e3):.0f} tokens/s, "
          f"6 N tokens / step time / 989 TFLOP/s = {ratio:.3f} (a ratio, not a claim), "
          f"peak {peak_gb:.1f} GB; {short[fwd]} {counts[fwd]} = 2 x {n} a step, "
          f"{short[bwd]} by path {counts[bwd]} = {n} a step, capped {capped[fwd]} and "
          f"{capped[bwd]}; {smi}")

    # one more step under the profiler: the device's busy share and top kernels
    step, *_ = make_train_step(cfg)
    it = batches(DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab), dev,
                 start_step=steps)
    batch_ = next(it)
    it.close()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch_)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, launched = _kernel_ms(prof)
    busy = sum(by_name.values())
    keys = {"flash_attention_bwd": ("bwd_dq", "bwd_dkdv", "bwd_rowstats", "bwd_delta"),
            "flash_attention": ("flash_fwd<",), "wkv6_bwd": ("wkv6_bwd",),
            "wkv6": ("wkv6_ring",)}
    shares = []
    for k in (bwd, fwd):
        ms = sum(t for name, t in by_name.items() if any(key in name for key in keys[k]))
        shares.append(f"{short[k]} {ms:.1f} ms ({ms / busy:.1%})")
    print(f"[train] {cfg.name} profiled step: device {busy:.1f} of {wall_ms:.1f} ms wall "
          f"({busy / wall_ms:.1%} busy), {launched} kernels; {', '.join(shares)}; top: "
          f"{_top(by_name, 6)}; {smi}")
    del params, opt
    return {"counts": counts, "capped": capped, "step_ms": steady}


def train_restart(dev) -> None:
    """``[train-restart]``: granite-3-2b cut to 2 full-width layers, batch 2 x
    256, 12 steps with a checkpoint every 5 and a failure injected before
    step 7, then a restart from step 5 to 12, against an uninterrupted run:
    the losses logged after the restart must equal the uninterrupted run's
    for steps 6-12, bit for bit or within 1e-6 relative, which is said.
    The checkpoints go under the temporary directory; where its disk holds
    less than 3 of them (~2.7 GB each), the reduced config is run instead,
    and said."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models.params import count_params, tree_leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    tmp = tempfile.mkdtemp(prefix="train_restart_")
    try:
        state_gb = 3 * 4 * count_params(make_train_step(cfg)[1]) / 1e9  # params, m, v
        free_gb = shutil.disk_usage(tmp).free / 1e9
        which = f"2 full-width layers ({state_gb:.1f} GB a checkpoint)"
        if free_gb < 4 * state_gb:
            cfg = get_config(TRAIN_ARCH).smoke()
            which = (f"the reduced config: {free_gb:.1f} GB free under the temporary "
                     f"directory, below 4 checkpoints of the 2-layer cut")
        kw = dict(steps=12, global_batch=2, seq_len=256, log_every=1, seed=0, device=dev)
        with contextlib.redirect_stdout(io.StringIO()):
            p_ref, _, want = train(cfg, **kw)
            try:
                train(cfg, ckpt_dir=tmp, ckpt_every=5, fail_at=7, **kw)
                raise AssertionError("[train-restart] the injected failure did not raise")
            except RuntimeError as e:
                if "injected failure at step 7" not in str(e):
                    raise
            p, o, got = train(cfg, ckpt_dir=tmp, ckpt_every=5, **kw)
        if int(o["step"]) != 12 or len(got) != 7:
            raise AssertionError(f"[train-restart] step {int(o['step'])}, losses {got}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want[5:]))
        exact = got == want[5:]
        params_equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(p_ref)))
        if not rel <= 1e-6:
            raise AssertionError(f"[train-restart] losses after the restart {got} vs "
                                 f"uninterrupted {want[5:]}")
        print(f"[train-restart] {cfg.name}, {which}, batch 2 x 256: 12 steps, checkpoint "
              f"every 5, failure injected at step 7, restart from step 5: losses of steps "
              f"6-12 {got} "
              + ("bit-equal to the uninterrupted run's" if exact else
                 f"within {rel:.2e} relative of the uninterrupted run's {want[5:]} (not "
                 f"bit-equal: a PyTorch op on the path, the embedding's index backward "
                 f"among them, adds with atomics)")
              + f"; final parameters {'bit-equal' if params_equal else 'not bit-equal'} ok")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_cli() -> None:
    """``[train-cli]``: ``python -m repro_torch.launch.train --arch ARCH
    --smoke --steps 4`` for granite-3-2b and rwkv6-3b, each in a process of
    its own, both started together, on the card's default device; each must
    exit 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = [["--arch", arch, "--smoke", "--steps", "4"] for arch in ("granite_3_2b", "rwkv6_3b")]
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *args],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args in runs]
    failed = []
    for args, proc in zip(runs, procs):
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        lines = out.strip().splitlines()
        print(f"[train-cli] {' '.join(args)}: rc {proc.returncode}; "
              + (" | ".join(lines[-2:]) if lines else "no output"))
        if proc.returncode != 0 or "step     4 loss" not in out:
            failed.append(f"{' '.join(args)}: {err[-2000:]}")
    if failed:
        raise AssertionError(f"[train-cli] failed: {failed}")


def executed_fleet(device):
    """3 ``ExecutorReplica``s (each a ``ServingExecutor`` of the flat
    big/small platform, every class on ``device``, blocks of side ``SIDE``,
    a persistent incremental-gp policy) behind the affinity router, on a
    stream of 3 steps.  -> (router report, counted replicas)."""
    from repro_torch.core.arena import make_request_stream
    from repro_torch.core.router import ReplicaRouter
    from repro_torch.core.schedulers import make_policy
    from repro_torch.core.serving import ExecutorReplica, ServingExecutor, groups_for_platform
    from repro_torch.launch.serve import heterogeneous_platform

    reps = []
    for i in range(3):
        plat = heterogeneous_platform()
        sx = ServingExecutor(groups_for_platform(plat, [device]), plat, side=SIDE)
        reps.append(_CountedReplica(ExecutorReplica(
            f"r{i}", sx, make_policy("incremental-gp", scale_by_workers=True))))
    stream = make_request_stream(3, base_requests=6, decode_chunks=2, churn=0.3,
                                 kv_bytes=SIDE * SIDE * 4, seed=0)
    try:
        return ReplicaRouter(reps, mode="affinity").run(stream), reps
    finally:
        for r in reps:
            r.inner.executor.close()


def router_phase(dev, modules: dict, smi: str) -> dict:
    """``[router]``: ``run_router`` (simulated) for every mode with a drain;
    then the executed fleet on the card, launches counted (set to 0 just
    before): every executed ``prefill`` a K1 launch, every ``decode`` a K2
    launch; then the fleet under a step clock on the card and on the CPU,
    both at side ``SIDE``: routing, warm hits and transfers equal.
    -> ({kernel: launches}, {kernel: launches by path}) of the counted run."""
    from repro_torch.core import executor as tex
    from repro_torch.core.router import MODES
    from repro_torch.launch.serve import run_router

    for mode in MODES:
        d = run_router(24, 8, replicas=3, mode=mode, steps=4, seed=0, drain_step=2).to_dict()
        if d["steps"] != 4 or d["kv_migrated_bytes"] <= 0:
            raise AssertionError(f"[router] mode={mode}: {d}")
        print(f"[router] mode={mode} replicas=3 steps={d['steps']} (simulated, drain before "
              f"step 2): mean_lat={d['mean_latency_ms']:.1f}ms p95={d['p95_latency_ms']:.1f}ms "
              f"fleet_mk={d['total_makespan_ms']:.1f}ms warm_hit={d['warm_hit_rate']:.0%} "
              f"migrated={d['kv_migrated_bytes'] / 2**20:.0f}MiB")

    for m in modules.values():
        m.reset_launches()
    t0 = time.perf_counter()
    report, reps = executed_fleet(dev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: getattr(modules[k], k).launches for k in ("matmul", "matadd")}
    by_path = {k: dict(getattr(modules[k], k).launches_by_path) for k in launches}
    ran = {op: sum(s.kernels_by_op.get(op, 0) for r in reps for s in r.reports)
           for op in ("prefill", "decode")}
    if launches != {"matmul": ran["prefill"], "matadd": ran["decode"]} or not all(ran.values()):
        raise AssertionError(f"[router] executed fleet: launches {launches} != executed {ran}")
    if by_path["matmul"]["wgmma"] != launches["matmul"]:
        raise AssertionError(f"[router] executed fleet: matmul by path {by_path['matmul']}")
    d = report.to_dict()
    if d["steps"] != 3 or d["warm_hits"] == 0 or not all(s.makespan_ms > 0 for s in report.steps):
        raise AssertionError(f"[router] executed fleet: {d}")
    print(f"[router] executed fleet of {len(reps)} ExecutorReplicas on {torch.cuda.get_device_name(0)}"
          f", side {SIDE}, 3 steps (stream cut to 6 requests x 2 decode chunks): wall {wall:.1f} "
          f"ms, fleet_mk={d['total_makespan_ms']:.3f}ms warm_hits={d['warm_hits']} "
          f"cold={d['cold']} transfers={d['transfers']}; launches {launches} == executed "
          f"prefill/decode {ran}, matmul by path {by_path['matmul']}; {smi}")

    saved = tex.time
    got = {}
    try:
        for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
            tex.time = StepClock()
            report, reps = executed_fleet(device)
            got[side] = {
                "routed": {r.name: r.routed for r in reps},
                "warm": [(s.warm_hits, s.warm_misses, s.cold) for s in report.steps],
                "transfers": [(s.transfers, s.bytes_moved) for s in report.steps],
            }
    finally:
        tex.time = saved
    if got["card"] != got["cpu"]:
        raise AssertionError(f"[router] executed fleet on a step clock: card {got['card']} != "
                             f"CPU {got['cpu']}")
    print(f"[router] executed fleet on a step clock, side {SIDE}: card == CPU on routing, warm "
          f"hits/misses/cold {got['card']['warm']} and transfers {got['card']['transfers']} ok")
    return launches, by_path


CLI_MODES = (
    ["--scheduler", "incremental-gp"],
    ["--arena", "--scenario", "moe", "--requests", "6", "--decode-chunks", "4", "--steps", "3"],
    ["--arena", "--requests", "24", "--steps", "4", "--replicas", "3", "--router", "all",
     "--drain-step", "2"],
    ["--arch", "granite_3_2b", "--smoke", "--requests", "8", "--decode-len", "16"],
    *(["--arch", arch, "--smoke", "--requests", "2", "--decode-len", "4"]
      for arch in ("granite_moe_3b_a800m", "minicpm3_4b", "whisper_large_v3",
                   "llava_next_mistral_7b", "deepseek_moe_16b", "jamba_1_5_large_398b",
                   "command_r_35b")),
)


def cli_phase() -> None:
    """``[cli]``: each new mode of ``python -m repro_torch.launch.serve`` in a
    subprocess of its own, all started together, each on the card's
    default device; every one must exit 0 (``--smoke`` decodes through one
    captured CUDA graph per step and says so)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [(args, subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *args],
                                     cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))
             for args in CLI_MODES]
    failed = []
    for args, proc in procs:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        lines = out.strip().splitlines()
        ok = proc.returncode == 0 and lines and (
            "--smoke" not in args or "one CUDA graph per step" in out)
        print(f"[cli] {' '.join(args)}: rc {proc.returncode}; "
              + (" | ".join(lines[-3:]) if lines else "no output"))
        if not ok:
            failed.append((args, proc.returncode, err[-2000:]))
    if failed:
        raise AssertionError(f"[cli] failed: {failed}")


def _load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_example(module, argv: list[str]):
    """-> (its stdout's lines, what its ``main`` returned)."""
    import contextlib
    import io

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        result = module.main(argv)
    return log.getvalue().splitlines(), result


def examples_phase(dev, smi) -> dict:
    """``[examples]``: the five ``examples/*_torch.py`` twins' ``main`` in
    this process with the reference scripts' own arguments, on the card.

    ``quickstart_torch`` runs on the card, K1's counters set to 0 just
    before, and then with ``--device cpu``: its 38 matmuls must be 38 K1
    launches, its printed schedule (the Formula (1)/(2) line and the
    policies' lines) and transfers the CPU run's, and each launch's output
    within ``mm_tol`` of the plain version on the same inputs where the
    plain product is finite (the reference's DAG squares and chains 256 x
    256 unit-normal blocks, so most of its products overflow f32, in the
    reference too; ROADMAP section 3, fault 8).  ``heterogeneous_serving_
    torch``'s reduced granite-3-2b serves in f32 (K3 in its prefill; the
    launches ``ops.warm_up`` makes first are taken out) and its scheduler
    lines are printed.  ``online_repartition_torch`` and
    ``elastic_repartition_torch`` run host code only.  ``train_lm_torch``
    trains lm-100m for its 250 steps of 4 x 128 in a fresh checkpoint
    directory, the counters set to 0 just before: one K3 and one K3b launch
    a layer and step (remat off), all on ``fp32``, and the loss must fall.
    Any twin that raises fails the run.  -> {"matmul": {path: n}, kernel:
    {path: n} for K3 and K3b}: the counted launches of the quickstart and
    of the served and trained f32 paths."""
    import re
    import shutil
    import tempfile

    from repro_torch.kernels import matmul as matmul_module
    from repro_torch.kernels import ops, ref

    mods = {name: _load_example(name) for name in (
        "quickstart_torch", "heterogeneous_serving_torch", "online_repartition_torch",
        "elastic_repartition_torch", "train_lm_torch")}
    counted = {}

    # quickstart: every K1 launch recorded beside its inputs
    launched = []
    kernel = ops.matmul

    def recording(a, b):
        out = kernel(a, b)
        launched.append((a, b, out))
        return out

    matmul_module.reset_launches()
    ops.matmul = recording
    try:
        card_lines, card = _run_example(mods["quickstart_torch"], ["--device", "cuda"])
    finally:
        ops.matmul = kernel
    counted["matmul"] = dict(matmul_module.matmul.launches_by_path)
    cpu_lines, cpu = _run_example(mods["quickstart_torch"], ["--device", "cpu"])
    n = sum(counted["matmul"].values())
    if n != 38 or len(launched) != 38:
        raise AssertionError(f"[examples] quickstart_torch: {n} K1 launches ({counted['matmul']}),"
                             f" {len(launched)} matmuls, want the DAG's 38")
    if card_lines[:4] != cpu_lines[:4] or card.n_transfers != cpu.n_transfers:
        raise AssertionError(f"[examples] quickstart_torch card {card_lines} vs cpu {cpu_lines}")
    finite, err = 0, 0.0
    for a, b, out in launched:
        want = ref.matmul(a.cpu(), b.cpu())
        if torch.isfinite(want).all():
            finite += 1
            scale = want.abs().max().item()
            torch.testing.assert_close(out.cpu(), want, **mm_tol(a.shape[1], torch.float32,
                                                                 scale))
            err = max(err, (out.cpu() - want).abs().max().item() / scale)
    same_exits = all(bool(torch.isfinite(card.outputs[k]).all()) == bool(torch.isfinite(v).all())
                     for k, v in cpu.outputs.items())
    for line in card_lines:
        print(f"[examples] quickstart_torch: {line}")
    print(f"[examples] quickstart_torch: the schedule lines and {card.n_transfers} transfers "
          f"equal the CPU run's; K1 {n} launches by path {counted['matmul']}; {finite} of 38 "
          f"products finite in the plain version, each within mm_tol (largest error "
          f"{err:.3g} x max |plain|), the others overflow f32 as the reference's do; "
          f"exit blocks finite as on the CPU: {same_exits}; {smi}")
    if not same_exits:
        raise AssertionError("[examples] quickstart_torch: exit blocks finite on one device only")
    del launched, card, cpu

    # heterogeneous serving: the reduced granite in f32, then the schedules
    _reset_counts()
    ops.warm_up(dev)
    warm = _counts()["flash_attention"]
    _reset_counts()
    lines, _ = _run_example(mods["heterogeneous_serving_torch"], ["--device", "cuda"])
    served = {p: m - warm[p] for p, m in _counts()["flash_attention"].items()}
    for line in lines:
        print(f"[examples] heterogeneous_serving_torch: {line}")
    print(f"[examples] heterogeneous_serving_torch: K3 {sum(served.values())} launches in the "
          f"f32 prefill by path {served} (ops.warm_up's {sum(warm.values())} taken out)")
    if served["fp32"] != sum(served.values()) or not served["fp32"]:
        raise AssertionError(f"[examples] the reduced granite's K3 launches {served}: want fp32")

    for name in ("online_repartition_torch", "elastic_repartition_torch"):
        lines, _ = _run_example(mods[name], [])
        for line in lines:
            print(f"[examples] {name}: {line}")

    # train_lm: 250 steps of 4 x 128 in a fresh checkpoint directory
    cfg = mods["train_lm_torch"].CFG
    tmp = tempfile.mkdtemp(prefix="train_lm_torch_")
    try:
        _reset_counts()
        t0 = time.perf_counter()
        lines, losses = _run_example(mods["train_lm_torch"], ["--ckpt-dir", tmp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = 250
    want = cfg.n_layers * steps
    for k in ("flash_attention", "flash_attention_bwd"):
        if counts[k]["fp32"] != want or sum(counts[k].values()) != want:
            raise AssertionError(f"[examples] train_lm_torch: {k} launched {counts[k]}, want "
                                 f"{want} on fp32 (one a layer and step, remat off)")
        counted[k] = {p: m + (served[p] if k == "flash_attention" else 0)
                      for p, m in counts[k].items()}
    step_ms = [float(m) for m in re.findall(r"\((\d+) ms/step\)", "\n".join(lines))]
    for line in lines[-3:]:
        print(f"[examples] train_lm_torch: {line}")
    print(f"[examples] train_lm_torch: lm-100m, {steps} steps of 4 x 128 in {wall:.1f} s; "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f} ({len(losses)} logged); ms a step "
          f"by logged interval {step_ms} (median {statistics.median(step_ms):.0f}); K3 "
          f"{counts['flash_attention']}, K3b {counts['flash_attention_bwd']} by path = "
          f"{cfg.n_layers} layers x {steps} steps; {smi}")
    return counted


def build_report(build) -> None:
    """One ``[build]`` line per kernel from ``ptxas -v``: registers, spills,
    static shared memory, the dynamic shared memory K1's ``wgmma`` path, K3,
    K3b and K4b's main pass set, for K4b's passes their resident warps an
    SM (the occupancy calculator's), and whether
    ``ptxas`` serialised the kernel's ``wgmma``s (its C7510-C7520 notes,
    which name the function).  K3 and K3b are built uncapped and capped
    (a logit cap; labelled ``capped``).  Raises when a K1 ``wgmma``, K3,
    K3b, K4 or K4b specialisation spills or is missing, when K4b's main
    pass at N 64 keeps fewer than 12 warps an SM, or when ``ptxas``
    serialised the ``wgmma``s of a bf16 K3b kernel, capped or not."""
    import ctypes
    import re

    lib = build.library()
    kernels, src, cur, serialised = [], None, None, set()
    for line in build.last_log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        elif m := re.search(r"wgmma.mma_async instructions are serialized.*function '(\w+)'",
                            line):
            serialised.add(m.group(1))
        elif m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
            k3 = re.search(r"\d(f32|bf16)\d+flash_fwdILi(\d+)ELb([01])E", name)
            k1 = re.search(r"mm_wgmmaI(f|13__nv_bfloat16)Lb([01])ELb([01])E", name)
            k3b = re.search(r"(bwd_dq|bwd_dkdv)(_wgmma)?I(f)?Li(\d+)ELb([01])E", name)
            cur = {"src": src, "name": name,
                   "k3": k3 and (k3.group(1), int(k3.group(2)), k3.group(3) == "1"),
                   "k1": k1 and ("f32" if k1.group(1) == "f" else "bf16",
                                 "KM"[int(k1.group(2))], "KN"[int(k1.group(3))]),
                   "k3b": k3b and (k3b.group(1), "f32" if k3b.group(3) else "bf16",
                                   int(k3b.group(4)), k3b.group(5) == "1")}
            kernels.append(cur)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            cur["spill"] = (int(m.group(1)), int(m.group(2)))
        elif m := re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line):
            cur["regs"], cur["smem"] = int(m.group(1)), int(m.group(2) or 0)
    k1, k3, k4, k3b, k4b = {}, {}, {}, {}, {}
    for kern in kernels:
        label = kern["name"]
        if m := re.search(r"wkv6_ringILi(\d+)E", kern["name"]):
            k4[int(m.group(1))] = kern
            label = f"wkv6_ring<N {m.group(1)}>"
        elif m := re.search(r"wkv6_bwd_(ckpt|main)ILi(\d+)E", kern["name"]):
            which, n = m.group(1), int(m.group(2))
            k4b[(which, n)] = kern
            label = f"wkv6_bwd_{which}<N {n}>"
            out = (ctypes.c_int * 3)()
            err = lib.repro_wkv6_bwd_info(n, int(which == "main"), out)
            if err:
                raise AssertionError(f"repro_wkv6_bwd_info({n}, {which}): CUDA error {err}")
            dynamic, threads, blocks = out
            kern["warps"] = blocks * threads // 32
            kern["smem"] = (f"{kern['smem']} bytes static + {dynamic} dynamic, {blocks} "
                            f"blocks of {threads // 32} warps = {kern['warps']} resident warps "
                            f"an SM")
        elif "wkv6_bwd_du" in kern["name"]:
            k4b[("du", 0)] = kern
            label = "wkv6_bwd_du"
        elif kern["k3"]:
            dtype, hd, capped = kern["k3"]
            k3[kern["k3"]] = kern
            label = f"flash_fwd<{dtype}, hd {hd}{', capped' if capped else ''}>"
            dynamic = lib.repro_flash_attention_smem(int(dtype == "bf16"), hd)
            kern["smem"] = f"{kern['smem']} bytes static + {dynamic} dynamic"
        elif kern["k3b"]:
            which, dtype, hd, capped = kern["k3b"]
            k3b[kern["k3b"]] = kern
            label = (f"{which}<{dtype}, hd {hd}{', capped' if capped else ''}>"
                     + (" (wgmma)" if dtype == "bf16" else ""))
            dynamic = lib.repro_flash_attention_bwd_smem(int(dtype == "bf16"),
                                                         int(which == "bwd_dkdv"), hd)
            kern["smem"] = f"{kern['smem']} bytes static + {dynamic} dynamic"
        elif kern["k1"]:
            dtype, a_major, b_major = kern["k1"]
            k1[kern["k1"]] = kern
            label = f"mm_wgmma<{dtype}, A {a_major}-major, B {b_major}-major>"
            dynamic = lib.repro_matmul_smem(int(dtype == "bf16"))
            kern["smem"] = f"{kern['smem']} bytes static + {dynamic} dynamic"
        elif "mm_fma" in kern["name"]:
            label = f"mm_fma<{'bf16' if 'bfloat16' in kern['name'] else 'f32'}>"
        elif "bwd_deltaIfE" in kern["name"]:
            label = "bwd_delta<f32>"
        elif "bwd_rowstats" in kern["name"]:
            label = "bwd_rowstats<bf16>"
        elif m := re.search(r"(add_stream|add_scalar)I(f|i|13__nv_bfloat16)E", kern["name"]):
            dtype = {"f": "f32", "i": "int32"}.get(m.group(2), "bf16")
            label = f"{m.group(1)}<{dtype}>"
        wgmma = ", wgmma serialised by ptxas" if kern["name"] in serialised else ""
        print(f"[build] {kern['src']} {label}: {kern['regs']} registers, spill stores/loads "
              f"{kern['spill'][0]}/{kern['spill'][1]} bytes, smem {kern['smem']}{wgmma}")
    want = {(dt, hd, c) for dt in ("f32", "bf16") for hd in (32, 64, 128) for c in (False, True)}
    if set(k3) != want:
        raise AssertionError(f"K3 specialisations built {sorted(k3)}, want {sorted(want)}")
    want = {(dt, a, b) for dt in ("f32", "bf16") for a in "KM" for b in "KN"}
    if set(k1) != want:
        raise AssertionError(f"K1 wgmma specialisations built {sorted(k1)}, want {sorted(want)}")
    want = {32, 64}
    if set(k4) != want:
        raise AssertionError(f"K4 specialisations built {sorted(k4)}, want {sorted(want)}")
    want = {(w, dt, hd, c) for w in ("bwd_dq", "bwd_dkdv") for dt in ("f32", "bf16")
            for hd in (32, 64, 128) for c in (False, True)}
    if set(k3b) != want:
        raise AssertionError(f"K3b specialisations built {sorted(k3b)}, want {sorted(want)}")
    want = {(w, n) for w in ("ckpt", "main") for n in (32, 64)} | {("du", 0)}
    if set(k4b) != want:
        raise AssertionError(f"K4b kernels built {sorted(k4b)}, want {sorted(want)}")
    if k4b[("main", 64)]["warps"] < 12:  # the design's occupancy at the training shape
        raise AssertionError(f"K4b's main pass at N 64: {k4b[('main', 64)]['warps']} resident "
                             f"warps an SM, want at least 12")
    spilled = [key for key, kern in {**k1, **k3, **k4, **k3b, **k4b}.items()
               if any(kern["spill"])]
    if spilled:
        raise AssertionError(f"K1 wgmma, K3, K3b, K4 or K4b specialisations spill: {spilled}")
    serial = [key for key, kern in k3b.items() if key[1] == "bf16" and kern["name"] in serialised]
    if serial:
        raise AssertionError(f"ptxas serialised the wgmmas of K3b's bf16 kernels {serial}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    # the port's package, next to this script: without it nothing is run
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.arena import make_request_stream
    from repro_torch.core.executor import TorchExecutor, attach_request_kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as flash_module
    from repro_torch.kernels import matadd as matadd_module
    from repro_torch.kernels import matmul as matmul_module
    from repro_torch.kernels import wkv6 as wkv6_module
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matadd import matadd
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.serve import request_dag, run_arena_executed

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    peaks = next((v for key, v in PEAKS if key in name), None)
    if peaks is None:
        raise ValueError(f"no published peaks on record for {name!r}; add them to PEAKS")
    # the special-function units' rate: 16 operations a clock on each SM at
    # the card's highest SM clock
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peaks = dict(peaks, mufu=MUFU_PER_SM_CLOCK * sms * max_mhz * 1e6)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"f32 peak {peaks['f32'] / 1e12:g} TFLOP/s, bf16 tensor peak "
          f"{peaks['bf16'] / 1e12:g} TFLOP/s, tf32 tensor peak {peaks['tf32'] / 1e12:g} "
          f"TFLOP/s, memory {peaks['bytes'] / 1e12:g} TB/s; special-function rate "
          f"{MUFU_PER_SM_CLOCK} x {sms} SMs x {max_mhz:g} MHz = {peaks['mufu']:.4g} op/s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def mark(phase: str) -> None:
        print(f"[phase] {phase} done at {time.perf_counter() - t_start:.1f} s")

    # 1. build
    t_build = time.perf_counter()
    lib = _build.build()
    _build.library()
    t_build = time.perf_counter() - t_build
    print(f"[build] {os.path.relpath(lib, ROOT)} in {t_build:.1f} s")
    build_report(_build)
    mark("build")

    # 2-5. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"matmul": check_matmul(matmul, ref, gen),
            "matadd": check_matadd(matadd, ref, gen)}
    errs["flash_attention"], errs["flash_attention+cap"] = check_flash(flash_attention, ref, gen)
    errs["wkv6"] = check_wkv6(wkv6, ref, gen)
    check_flash_lse(gen)
    errs["flash_attention_bwd"], errs["flash_attention_bwd+cap"] = check_flash_bwd(gen)
    errs["wkv6_bwd"] = check_wkv6_bwd(gen)
    mark("kernel checks")

    # 6. times at the main paths' shapes: prefill = x @ x.T, decode = x + x,
    # granite-3-2b prefill attention, rwkv6-3b prefill recurrence
    a = torch.randn(SIDE, SIDE, device=dev, generator=gen)
    b = torch.randn(SIDE, SIDE, device=dev, generator=gen)
    bt = b.T
    f32 = a.element_size()
    block = SIDE * SIDE * f32  # each input read once, the output written once
    # K1 in f32 is three TF32 passes on the tensor cores (3xTF32); the bound of
    # the same product in IEEE f32 FMAs on the CUDA cores is printed beside it
    bounds = {
        "matmul": bound(3 * 2.0 * SIDE**3, 3 * block, peaks["tf32"], peaks["bytes"]),
        "matadd": bound(float(SIDE * SIDE), 3 * block, peaks["f32"], peaks["bytes"]),
    }
    fma_bound = bound(2.0 * SIDE**3, 3 * block, peaks["f32"], peaks["bytes"])
    # K4 on the CUDA cores: the one-step recurrence needs at least 3 FP32
    # instructions per state element and step (k v, the decayed update, the
    # r-weighted sum), the kernel's two-step form 2.5; an FMA is one
    # instruction, so the f32 FLOP/s peak counts 2 per instruction
    Bw, Hw, Sw, Nw = K4_SHAPE
    k4_issue_ms = {n: n * Bw * Hw * Sw * Nw * Nw / (peaks["f32"] / 2) * 1e3 for n in (3.0, 2.5)}
    # the timing phase's launches are not the main path's: the counters are
    # reset to 0 right before each path below
    times = {
        "matmul": (time_ms(lambda: matmul(a, bt)), time_ms(lambda: ref.matmul(a, bt)),
                   time_ms(lambda: torch.matmul(a, bt))),
        "matadd": (time_ms(lambda: matadd(a, b)), time_ms(lambda: ref.matadd(a, b)),
                   time_ms(lambda: torch.add(a, b))),
    }
    paced = {"matmul": time_ms(lambda: matmul(a, bt), queued=False),
             "matadd": time_ms(lambda: matadd(a, b), queued=False)}
    more_times, more_bounds = time_attention_and_wkv6(flash_attention, wkv6, ref, gen, peaks)
    times.update(more_times)
    bounds.update(more_bounds)
    times["flash_attention_bwd"], bounds["flash_attention_bwd"], k3b_bound7, k3_lse_ms, \
        k3b_split = time_flash_bwd(gen, peaks)
    times["wkv6_bwd"], bounds["wkv6_bwd"], k4b_split, k4b_scratch = time_wkv6_bwd(gen, peaks)
    # K3 and K3b with the capped granite's attention cap, at granite's shapes;
    # the library call is flex_attention with the cap as its score_mod
    cap = get_config("granite_3_2b+softcap").attn_logit_softcap
    times["flash_attention+cap"], bounds["flash_attention+cap"] = time_flash(
        flash_attention, ref, gen, peaks, K3_SHAPE, cap=cap)
    times["flash_attention_bwd+cap"], bounds["flash_attention_bwd+cap"], k3b_cap_bound6, \
        k3_lse_cap_ms, k3b_cap_split = time_flash_bwd(gen, peaks, cap)
    # K3 and K3b on their f32 paths at lm-100m's training shape ([examples])
    f32_times, f32_bounds, f32_errs = time_flash_f32(gen, peaks)
    times.update(f32_times)
    bounds.update(f32_bounds)
    errs.update(f32_errs)
    shapes = {"matmul": f"{SIDE}^3 f32", "matadd": f"{SIDE}^2 f32",
              "flash_attention": "B{} H{}/K{} S{} hd{} bf16 causal".format(*K3_SHAPE),
              "wkv6": "B{} H{} S{} N{} f32".format(*K4_SHAPE),
              "flash_attention_bwd": "B{} H{}/K{} S{} hd{} bf16 causal (granite-3-2b's training "
                                     "shape; the bound counts 10 hd operations a kept pair)"
                                     .format(*K3_SHAPE),
              "wkv6_bwd": "B{} H{} S{} N{} f32 (rwkv6-3b's training shape, no final-state "
                          "gradient; the bound counts 14 operations a state element and step; "
                          "the plain version is a Python loop)".format(*K4_SHAPE),
              "flash_attention+cap": "B{} H{}/K{} S{} hd{} bf16 causal, logit cap {:g} (the "
                                     "capped granite-3-2b's prefill; the bound is the larger of "
                                     "the tensor bound and 3 special-function operations a kept "
                                     "pair; library flex_attention with the cap as score_mod)"
                                     .format(*K3_SHAPE, cap),
              "flash_attention_bwd+cap": "B{} H{}/K{} S{} hd{} bf16 causal, logit cap {:g} (the "
                                         "capped granite-3-2b's training shape; the bound is the "
                                         "larger of the five-product bound and 3 special-"
                                         "function operations a kept pair; library "
                                         "torch.autograd.grad through flex_attention)"
                                         .format(*K3_SHAPE, cap),
              "flash_attention+f32": "B{} H{}/K{} S{} hd{} f32 causal (lm-100m's training "
                                     "attention, examples/train_lm_torch.py; fp32 path, CUDA "
                                     "cores; bound at the f32 peak)".format(*LM100M_K3),
              "flash_attention_bwd+f32": "B{} H{}/K{} S{} hd{} f32 causal (lm-100m's training "
                                         "attention; fp32 path, CUDA cores; bound 10 hd a kept "
                                         "pair at the f32 peak; library torch.autograd.grad "
                                         "through SDPA)".format(*LM100M_K3)}
    rows = [(k, shapes[k], t, bounds[k]) for k, t in times.items()]
    # K3 beside granite's shape: minitron-4b's prefill (head_dim 128),
    # minicpm3-4b's MLA prefill (96, on the pad path), whisper-large-v3's
    # encoder (1500 x 1500, not causal) and one decode step's cross-attention
    # (one query over the 1500 frames)
    k3_ms = {}
    for label, shape, causal, sq in (("minitron_4b", K3_MINITRON, True, None),
                                     ("minicpm3_4b", K3_MINICPM3, True, None),
                                     ("command_r_35b", K3_COMMAND_R, True, None),
                                     ("whisper_large_v3", K3_WHISPER, False, None),
                                     ("whisper decode", K3_WHISPER, False, 1)):
        t, bnd = time_flash(flash_attention, ref, gen, peaks, shape, causal, sq)
        k3_ms[label] = t[0]
        B_, H_, K_, S_, hd_ = shape
        desc = (f"B{B_} H{H_}/K{K_} Sq{sq or S_} Sk{S_} hd{hd_} bf16 "
                f"{'causal' if causal else 'full'} ({label})")
        rows.insert(3 + len(k3_ms) - 1, ("flash_attention", desc, t, bnd))
    for k, shape, (ms, plain, lib_ms), (b_ms, b_by) in rows:
        lib_txt = "none (no single PyTorch call)" if lib_ms is None else f"{lib_ms:.4f} ms"
        extra = f"; host-paced kernel {paced[k]:.4f} ms/call" if k in paced else ""
        if k == "matmul":
            b_by += (f", 3xTF32 at the tf32 tensor peak; IEEE f32 FMA bound "
                     f"{fma_bound[0]:.4f} ms ({fma_bound[1]})")
        if k == "flash_attention_bwd":
            b_by += (f"; seven-product bound {k3b_bound7[0]:.4f} ms ({k3b_bound7[1]}, 14 hd a "
                     f"kept pair: S and dP in both kernels)")
        if k == "flash_attention_bwd+cap":
            b_by += (f"; the design's bound {k3b_cap_bound6[0]:.4f} ms ({k3b_cap_bound6[1]}: "
                     f"seven products and 6 special-function operations a kept pair, the tanh "
                     f"and P in both kernels)")
        if k == "flash_attention+cap":
            pairs = math.prod(K3_SHAPE[:2]) * K3_SHAPE[3] * (K3_SHAPE[3] + 1) / 2
            b_by += (f"; {2.0 * pairs / peaks['mufu'] * 1e3:.4f} ms at 2 special-function "
                     f"operations a kept pair (tanh.approx.f32, ~2^-11 relative, and ex2)")
        if k == "wkv6":
            b_by += (f"; CUDA-core issue floor {k4_issue_ms[3.0]:.4f} ms (3 FP32 "
                     f"instructions per state element and step at {peaks['f32'] / 2e12:g}e12/s; "
                     f"{k4_issue_ms[2.5]:.4f} ms at the two-step form's 2.5)")
        print(f"[time] {k} {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib_txt}, bound {b_ms:.4f} ms ({b_by}){extra}; {smi}")
    print(f"[time] flash_attention with its LSE (flash_attention_fwd, the training forward) "
          "B{} H{}/K{} S{} hd{} bf16 causal: kernel ".format(*K3_SHAPE)
          + f"{k3_lse_ms:.4f} ms (without: {times['flash_attention'][0]:.4f} ms); {smi}")
    print(f"[time] flash_attention with its LSE, capped at {cap:g}: kernel {k3_lse_cap_ms:.4f} ms "
          f"(without: {times['flash_attention+cap'][0]:.4f} ms); {smi}")
    print(f"[time] flash_attention_bwd library = torch.autograd.grad through "
          f"scaled_dot_product_attention(is_causal=True), the backward alone; by kernel "
          f"(torch.profiler, ms a launch): "
          + ", ".join(f"{k} {t:.4f}" for k, t in sorted(k3b_split.items()))
          + "; capped at {:g}: ".format(cap)
          + ", ".join(f"{k} {t:.4f}" for k, t in sorted(k3b_cap_split.items())) + f"; {smi}")
    print("[time] wkv6_bwd by pass (torch.profiler, ms a launch): "
          + ", ".join(f"{k} {k4b_split.get(k, 0.0):.4f}" for k in ("ckpt", "main", "du"))
          + f"; checkpoint scratch {k4b_scratch} bytes at " + "B{} H{} S{} N{}".format(*K4_SHAPE)
          + f"; {smi}")

    mark("time")

    # 7. one request chain on the card vs the CPU, same host inputs
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
    del a, b, bt, g, inputs, got, want

    # 8. the executed serving arena, counted
    matmul_module.reset_launches()
    matadd_module.reset_launches()
    wall0 = time.perf_counter()
    _, arena = run_arena_executed(
        STREAM["n_requests"], STREAM["decode_chunks"], steps=STREAM["steps"],
        drop_step=STREAM["drop_step"], seed=STREAM["seed"], side=SIDE, device=dev)
    torch.cuda.synchronize()
    arena_wall_ms = (time.perf_counter() - wall0) * 1e3
    launches = {"matmul": matmul.launches, "matadd": matadd.launches}
    matmul_by_path = dict(matmul.launches_by_path)
    matadd_by_path = dict(matadd.launches_by_path)
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
    if matmul_by_path["wgmma"] != launches["matmul"]:
        raise AssertionError(f"matmul launches by path {matmul_by_path}: every prefill must "
                             f"run the wgmma path")
    print(f"[arena] launches {launches} == executed prefill/decode {by_op}; matmul by path "
          f"{matmul_by_path}; {smi}")
    kernel_ms = sum(launches[k] * times[k][0] for k in launches)
    print(f"[arena] wall {arena_wall_ms:.1f} ms for all policies; launches x kernel "
          f"time {kernel_ms:.1f} ms (device busy share ~{kernel_ms / arena_wall_ms:.1%})")
    del arena
    gc.collect()
    torch.cuda.empty_cache()
    mark("chain and arena")

    # 9. the fused path: CUDA graphs of group-steps, serialized and in async
    # waves; every path of every kernel warmed first, so no build or
    # attribute setting lands inside a capture or a counted run
    ops.warm_up(dev)
    modules = {"matmul": matmul_module, "matadd": matadd_module,
               "flash_attention": flash_module, "wkv6": wkv6_module}
    check_fused(dev, modules, smi)
    fused_by_path, fused_walls = arena_fused(dev, modules, smi)
    for mode, (wall, n) in fused_walls.items():
        busy = sum(n[k] * times[k][0] for k in n)
        print(f"[arena-fused] wall {wall:.1f} ms for all policies ({mode}; unfused "
              f"{arena_wall_ms:.1f} ms); launches x kernel time {busy:.1f} ms (device busy "
              f"share ~{busy / wall:.1%}); {smi}")
    for k in ("matmul", "matadd"):
        launches[k] += sum(fused_by_path[k].values())
    by_path_arena = {k: {p: n + fused_by_path[k][p] for p, n in by.items()}
                     for k, by in (("matmul", matmul_by_path),
                                   ("matadd", matadd_by_path))}
    gc.collect()
    torch.cuda.empty_cache()

    mark("fused")

    # 10. the model's own context: 2 full-width layers, card against CPU
    for arch in CARD_VS_CPU:
        card_vs_cpu(arch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    mark("card-vs-cpu")

    # 11. full-width serving, one model after the other; a kernel's launches
    # in the JSON line are summed over the models it serves (K1's and K2's
    # over the unfused and the two fused arenas and the router's fleet)
    by_path = dict(by_path_arena)
    # the prefill kernel's time at each model's own prefill shape, where it
    # was timed above
    serve_kernel_ms = {"granite_3_2b": times["flash_attention"][0], "rwkv6_3b": times["wkv6"][0],
                       "minitron_4b": k3_ms["minitron_4b"], "minicpm3_4b": k3_ms["minicpm3_4b"],
                       "command_r_35b": k3_ms["command_r_35b"],
                       "granite_3_2b+softcap": times["flash_attention+cap"][0]}
    # the capped kernels' launches: those of the models with an attention cap
    # (also counted in their kernel's own total)
    launches["flash_attention+cap"] = launches["flash_attention_bwd+cap"] = 0
    for arch, kname, prompt_len, cut, n_requests in SERVED:
        cfg = served_config(arch, cut)
        if arch in INIT_CHECKED:
            init_in_dtype(cfg, dev)
            gc.collect()
            torch.cuda.empty_cache()
        run = serve_full_width(cfg, kname, prompt_len, n_requests, dev, smi)
        launches[kname] = launches.get(kname, 0) + run["launches"]
        if run["capped"]:
            launches[f"{kname}+cap"] += run["capped"]
        if run["by_path"] is not None:
            by_path[kname] = {p: n + by_path.get(kname, {}).get(p, 0)
                              for p, n in run["by_path"].items()}
        if arch in serve_kernel_ms:
            busy = run["launches"] * serve_kernel_ms[arch]
            print(f"[serve] {arch}: {kname} launches x kernel time = {busy:.1f} ms, "
                  f"{busy / run['prefill_ms']:.1%} of the prefill")
        gc.collect()
        torch.cuda.empty_cache()
        if arch in PROFILED:
            profile_serving(cfg, prompt_len, n_requests, dev, PROFILE_KEY[kname])
            gc.collect()
            torch.cuda.empty_cache()
        if arch in PREFILL_SPLIT:
            prefill_split(cfg, prompt_len, n_requests, dev, smi)
            gc.collect()
            torch.cuda.empty_cache()

    mark("serve")

    # 12. decode as one CUDA graph per step against the eager loop, same call
    for arch, _, prompt_len, cut, n_requests in SERVED:
        decode_graph(served_config(arch, cut), prompt_len, n_requests, dev, smi)
        gc.collect()
        torch.cuda.empty_cache()

    mark("decode-graph")

    # 13. the fleet router: simulated modes, then executed replicas on K1/K2
    fleet, fleet_by_path = router_phase(dev, modules, smi)
    for k, n in fleet.items():
        launches[k] += n
        by_path[k] = {p: m + fleet_by_path[k][p] for p, m in by_path[k].items()}
    gc.collect()
    torch.cuda.empty_cache()

    mark("router")

    # 14. the CLI's new modes, each a process of its own
    cli_phase()
    mark("cli")

    # 15. training: a full-width step on the card against the CPU, then
    # granite-3-2b at full width and depth, a crash and restart, the CLI
    for arch in TRAIN_VS_CPU:
        train_vs_cpu(arch, dev)
        gc.collect()
    torch.cuda.empty_cache()
    mark("train-vs-cpu")
    for k in ("flash_attention_bwd", "wkv6_bwd"):  # their main path is training's
        launches[k] = 0
        by_path[k] = dict.fromkeys(ops.KERNELS[k].launches_by_path, 0)
    for arch, batch, steps in TRAIN_RUNS:
        run = train_full(arch, batch, steps, dev, smi)
        for k, counts in run["counts"].items():
            launches[k] += sum(counts.values())
            by_path[k] = {p: n + by_path[k].get(p, 0) for p, n in counts.items()}
            if run["capped"][k]:
                launches[f"{k}+cap"] += run["capped"][k]
        del run
        gc.collect()
        torch.cuda.empty_cache()
    mark("train")
    train_restart(dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_cli()
    mark("train-cli")

    # 16. the examples/ twins; the capped rows' way, the f32 rows count the
    # f32 launches of the served reduced granite and of lm-100m's training,
    # which their kernel's own total also counts
    ex = examples_phase(dev, smi)
    for k, counts in ex.items():
        launches[k] += sum(counts.values())
        by_path[k] = {p: n + by_path[k].get(p, 0) for p, n in counts.items()}
        if k != "matmul":
            launches[f"{k}+f32"] = counts["fp32"]
    mark("examples")
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for k, (ms, plain, lib_ms) in times.items():
        base = k.partition("+")[0]  # a capped kernel: its kernel's specialisation
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{base}.cu",
            "replaces": REPLACES[base],
            "launches": launches[k],
            "max_abs_err": errs[k],
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1],
            "library_ms": lib_ms,
        })
        if k in by_path:
            kernels[-1]["launches_by_path"] = by_path[k]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
