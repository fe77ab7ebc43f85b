"""Granite 3.0 2B base — dense GQA, tied embeddings.
[hf:ibm-granite/granite-3.0-2b-base].  40L d_model=2048 32H kv=8
d_ff=8192 vocab=49155."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    d_model=2048, n_layers=40, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155, tie_embeddings=True,
    unit=(LayerSpec("attn", "dense"),),
)
