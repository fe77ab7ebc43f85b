"""End-to-end training on the PyTorch port (the twin of
``examples/train_lm.py``): a ~100M-parameter dense LM trained for a few
hundred steps on one device, with checkpointing + restart.  On the card
each attention layer's forward is the CUDA flash-attention kernel and its
backward the CUDA flash-attention backward, on their f32 paths (the plain
versions with ``--device cpu``).  The reference's one-device mesh is not
taken: the port's trainer runs on one device.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]

A rerun in the same ``--ckpt-dir`` resumes from its last checkpoint (the
last step, after a whole run: no step is left to log).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.launch.serve import default_device
from repro_torch.launch.steps import DistConfig
from repro_torch.launch.train import train

# ~100M params: 8 layers, d=768, GQA 12:4, tied embeddings
CFG = ModelConfig(
    name="lm-100m", family="dense", d_model=768, n_layers=8, n_heads=12,
    n_kv_heads=4, d_ff=2304, vocab=32000, tie_embeddings=True,
    unit=(LayerSpec("attn", "dense"),),
    activation_dtype="float32", remat=False,
)


def main(argv=None):
    """Train; returns the logged losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str,
                    default=os.path.join(tempfile.gettempdir(), "repro_lm100m_torch"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu, where the kernels' plain versions run")
    args = ap.parse_args(argv)
    _, _, losses = train(
        CFG, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=20,
        dist=DistConfig(remat=False),
        device=default_device(None if args.device == "cuda" else "cpu"))
    print(f"first logged loss {losses[0]:.3f} -> last {losses[-1]:.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss should decrease")
    return losses


if __name__ == "__main__":
    main()
