"""Granite 3.0 MoE 3B (800M active) — fine-grained 40-expert top-8 MoE.
[hf:ibm-granite/granite-3.0-*-base].  32L d_model=1536 24H kv=8
expert d_ff=512, vocab=49155.  40 experts pad to 48 slots for EP over 16
model shards (dummy slots are never routed; see DESIGN.md)."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    d_model=1536, n_layers=32, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, tie_embeddings=True,
    unit=(LayerSpec("attn", "moe"),),
    n_experts=40, top_k=8, moe_d_ff=512,
)
