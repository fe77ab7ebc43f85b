"""MiniCPM3 4B — MLA (multi-head latent attention), 62 layers.
[hf:openbmb/MiniCPM3-4B].  d_model=2560, 40H, d_ff=6400, vocab=73448;
MLA: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64.
Decode caches the 288-dim latent, scored with absorbed weights."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    d_model=2560, n_layers=62, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448, head_dim=96,  # qk_nope+qk_rope
    kv_lora_rank=256, q_lora_rank=768,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    unit=(LayerSpec("mla", "dense"),),
)
