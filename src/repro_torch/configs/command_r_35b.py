"""Command-R 35B — dense GQA, no biases, 256k vocab (chunked CE).
[hf:CohereForAI/c4ai-command-r-v01].  40L d_model=8192 64H kv=8
d_ff=22528 vocab=256000."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    d_model=8192, n_layers=40, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256000, rope_theta=8e6,
    unit=(LayerSpec("attn", "dense"),),
)
