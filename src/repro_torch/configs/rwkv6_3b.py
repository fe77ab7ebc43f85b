"""RWKV-6 "Finch" 3B — attention-free, data-dependent decay.
[arXiv:2404.05892; hf].  32L d_model=2560 d_ff=8960 vocab=65536,
head_size 64 (40 heads).  long_500k runs: O(1)-state recurrent decode."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    d_model=2560, n_layers=32, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, rwkv_head_size=64,
    unit=(LayerSpec("rwkv6", "dense"),),
    subquadratic=True,
)
