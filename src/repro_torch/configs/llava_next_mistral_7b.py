"""LLaVA-NeXT (mistral-7b backbone) — VLM; anyres tiling STUB:
input_specs provides precomputed (B, 576, d_model) patch embeddings for one
24x24 tile. [hf:llava-hf/llava-v1.6-mistral-7b-hf].  Backbone: 32L
d_model=4096 32H kv=8 d_ff=14336 vocab=32000."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, rope_theta=1e6,
    unit=(LayerSpec("attn", "dense"),),
    vlm=True, n_patches=576,
)
