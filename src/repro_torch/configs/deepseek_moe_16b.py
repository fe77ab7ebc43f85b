"""DeepSeekMoE 16B — fine-grained MoE: 2 shared + 64 routed top-6; layer 0
has a dense FFN (d_ff=10944). [arXiv:2401.06066; hf].
28L d_model=2048 16H kv=16 (MHA) expert d_ff=1408 vocab=102400."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    d_model=2048, n_layers=28, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400,
    prefix=(LayerSpec("attn", "dense"),),
    unit=(LayerSpec("attn", "moe"),),
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
)
