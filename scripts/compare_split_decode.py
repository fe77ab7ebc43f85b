"""Decodes whisper-large-v3 at full width (bf16, weights and prompts from
seed 0 as ``serve_smoke`` draws them: 8 requests of 416 tokens over its 1500
encoder frames) greedily for 32 steps twice from one prefill, eagerly: once
with K3's decode cross-attention (one query row) on its ``split`` path and
once on the prefill launch (``SPLIT_MAX_SQ`` set to 0, the route before the
split path existed).  Prints, for each step, the largest |logit difference|
between the two runs relative to the largest |logit|, and at the first
request and step whose greedy tokens differ, both runs' two largest logits
there; then each run's tokens' sha256 (the one ``chip_smoke.py``'s
``[serve]`` prints).  So a token that differs can be told from a fault: a
flip between near-tied logits after differences of a few bf16 roundings.

    python3 scripts/compare_split_decode.py

Needs a CUDA device; builds the kernels on first use.
"""

import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from repro_torch.configs.registry import make_batch
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params, tree_leaves, tree_map

    if not torch.cuda.is_available():
        raise RuntimeError("compare_split_decode needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = cs.served_config("whisper_large_v3", {})
    B, S, n = 8, 416, 32
    ctx = Ctx(dtype=torch.bfloat16)
    with torch.inference_mode():
        params = init_params(T.model_param_specs(cfg), torch.Generator(dev).manual_seed(0),
                             ctx.dtype)
        batch = make_batch(cfg, S, B, train=False,
                           generator=torch.Generator(dev).manual_seed(0))
        batch = {k: v.to(dev) for k, v in batch.items()}
        cache, logits = T.prefill(params, batch, cfg, ctx, cache_len=S + n)
        tok0 = logits.argmax(-1)
        saved = tree_map(torch.clone, cache)
        runs = {}
        for label, max_sq in (("split", k3.SPLIT_MAX_SQ), ("prefill launch", 0)):
            for dst, src in zip(tree_leaves(cache), tree_leaves(saved)):
                dst.copy_(src)
            k3.reset_launches()
            default, k3.SPLIT_MAX_SQ = k3.SPLIT_MAX_SQ, max_sq
            try:
                tok, toks, logs = tok0, [tok0], []
                for i in range(n):
                    step_logits = T.decode_step(params, cache, tok, S + i, cfg, ctx)[0]
                    logs.append(step_logits.float().clone())
                    tok = step_logits.argmax(-1)
                    toks.append(tok)
            finally:
                k3.SPLIT_MAX_SQ = default
            runs[label] = (torch.stack(toks, 1).cpu(), logs, dict(k3.flash_attention.launches_by_path))
    (ta, la, pa), (tb, lb, pb) = runs["split"], runs["prefill launch"]
    print(f"[compare] whisper-large-v3 eager decode, {n} steps of {B} requests; K3 launches by "
          f"path: split run {pa}, prefill-launch run {pb}")
    first = None
    for i, (a, b) in enumerate(zip(la, lb)):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        same = torch.equal(a.argmax(-1), b.argmax(-1))
        print(f"[compare] step {i}: max |logit difference| / max |logit| {rel:.3e}; "
              f"greedy tokens {'equal' if same else 'differ'}")
        if not same and first is None:
            first = i
            r = int((a.argmax(-1) != b.argmax(-1)).nonzero()[0])
            for label, x in (("split", a), ("prefill launch", b)):
                top = x[r].topk(2)
                print(f"[compare]   request {r}, {label}: two largest logits "
                      f"{top.values[0].item():.6f} (token {top.indices[0].item()}), "
                      f"{top.values[1].item():.6f} (token {top.indices[1].item()}); gap "
                      f"{(top.values[0] - top.values[1]).item():.3e}")
            break  # after the first differing token the two runs decode different prompts
    for label, (toks, _, _) in runs.items():
        print(f"[compare] {label}: tokens sha256 "
              f"{hashlib.sha256(toks.numpy().tobytes()).hexdigest()[:16]}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
