"""Minitron 4B — width-pruned Nemotron geometry. [arXiv:2407.14679; hf].
32L d_model=3072 24H kv=8 head_dim=128 d_ff=9216 vocab=256000."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    d_model=3072, n_layers=32, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256000,
    unit=(LayerSpec("attn", "dense"),),
)
