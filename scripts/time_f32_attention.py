"""Times K3's and K3b's f32 paths (``flash_attention`` and
``flash_attention_bwd`` on ``fp32``) of the port found under TREE/src, at
lm-100m's training shape and at whisper-large-v3's f32 encoder, with this
checkout's ``chip_smoke.time_flash_f32`` (each kernel first held to its plain
version, then kernel, plain and SDPA times on CUDA events).  TREE may be an
unpacked ``git archive`` of another commit, so two commits are timed by one
function in one call on the card:

    python3 scripts/time_f32_attention.py PARENT_DIR parent
    python3 scripts/time_f32_attention.py . change

Each line is ``[LABEL] name: kernel, plain, library ms`` with the card's
name and power limit.  Needs a CUDA device; builds TREE's kernels on first
use.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    tree, label = (argv if argv is not None else sys.argv[1:])[:2]
    src = os.path.join(os.path.abspath(tree), "src")
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import _build

    if not repro_torch.__file__.startswith(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not the port under {src}")
    if not torch.cuda.is_available():
        raise RuntimeError("time_f32_attention needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    peaks = next(v for key, v in cs.PEAKS if key in torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for args in ((), (cs.K3_WHISPER_F32, False, "_whisper")):
        times, _, errs, _ = cs.time_flash_f32(gen, peaks, *args)
        for name, (ms, plain, lib) in times.items():
            print(f"[{label}] {name}: kernel {ms:.4f} ms plain {plain:.4f} library {lib:.4f} "
                  f"err {errs[name]:.3e}; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
