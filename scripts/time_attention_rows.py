"""Times K3 (``flash_attention``, bf16) of the port found under TREE/src at
the shapes of its slowest rows against SDPA, with this checkout's
``chip_smoke.time_flash`` (kernel, plain and SDPA times on CUDA events, the
bound from the caller's head dim): minicpm3-4b's MLA prefill (8, 40/40,
2048, hd 96, causal), whisper-large-v3's decode cross-attention (8, 20/20,
one query over 1500 frames, hd 64) and, as a control the change should not
move, granite-3-2b's prefill (8, 32/8, 2048, hd 64, causal).  TREE may be
an unpacked ``git archive`` of another commit, so two commits are timed by
one function in one call on the card, in turns:

    python3 scripts/time_attention_rows.py PARENT_DIR parent
    python3 scripts/time_attention_rows.py . change --check

Each line is ``[LABEL] row: path, kernel, plain, SDPA and bound ms`` with
the card's name and power limit, then the device ms a call of each kernel
the row launched (``torch.profiler`` over 50 calls: the split path's two).
``--check`` first builds TREE's kernels with ``chip_smoke.build_report``
and runs ``chip_smoke``'s ``[K3]``, ``[K3-lse]`` and ``[K3b]`` checks
(TREE must be this checkout's port).
Needs a CUDA device; builds TREE's kernels on first use.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_ms(fn, calls: int) -> dict[str, float]:
    """-> {kernel name (its template, cut at the argument list): device ms
    a call} over ``calls`` calls of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+<[^<>]*>)\(", e.name)
            name = m.group(1) if m else e.name[:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return out


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    tree, label = args[:2]
    src = os.path.join(os.path.abspath(tree), "src")
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention

    if not repro_torch.__file__.startswith(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not the port under {src}")
    if not torch.cuda.is_available():
        raise RuntimeError("time_attention_rows needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    peaks = next(v for key, v in cs.PEAKS if key in torch.cuda.get_device_name(0))
    _build.build()
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--check" in args:
        cs.build_report(_build)
        cs.check_flash(flash_attention, ref, gen)
        cs.check_flash_lse(gen)
        cs.check_flash_bwd(gen)
    rows = (("minicpm3-4b prefill", cs.K3_MINICPM3, True, None),
            ("whisper-large-v3 decode cross-attention", cs.K3_WHISPER, False, 1),
            ("granite-3-2b prefill", cs.K3_SHAPE, True, None))
    for name, shape, causal, sq in rows:
        B, H, K, S, hd = shape
        q = torch.zeros(B, sq or S, H, hd, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
        kv = torch.zeros(B, S, K, hd, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
        _, path = cs.paths_taken(flash_attention, lambda: flash_attention(q, kv, kv, causal=causal))
        (ms, plain, sdpa), (b_ms, b_by) = cs.time_flash(flash_attention, ref, gen, peaks, shape,
                                                        causal, sq)
        by_kernel = _device_ms(lambda: flash_attention(q, kv, kv, causal=causal), 50)
        print(f"[{label}] {name} B{B} H{H}/K{K} Sq{sq or S} Sk{S} hd{hd}: path {path[0]}, "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {sdpa:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); by kernel (torch.profiler, ms a call) "
              + ", ".join(f"{k} {t:.4f}" for k, t in by_kernel.items()) + f"; {smi}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
