"""Jamba 1.5 Large (398B) — hybrid Mamba+attention 1:7 interleave, MoE 16e
top-2 on every other layer. [arXiv:2403.19887; hf].
72L d_model=8192 64H kv=8 d_ff=24576 vocab=65536.

Layer pattern (HF: attn period 8 offset 4; expert period 2 offset 1):
layer i is attention iff i % 8 == 4, MoE iff i % 2 == 1 — one 8-layer scan
unit x 9.  Params ≈ 398B; fits one 256-chip v5e pod with bf16 params +
bf16 Adam moments + FSDP over the "data" axis (see DESIGN.md)."""
from .base import LayerSpec, ModelConfig

_UNIT = tuple(
    LayerSpec("attn" if i % 8 == 4 else "mamba",
              "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    d_model=8192, n_layers=72, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    unit=_UNIT,
    n_experts=16, top_k=2, moe_d_ff=24576,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    param_dtype="bfloat16", optstate_dtype="bfloat16", fsdp=True,
    subquadratic=True,
)
