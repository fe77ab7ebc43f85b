"""Whisper large-v3 backbone — encoder-decoder, conv frontend STUB
(input_specs provides precomputed (B, 1500, d_model) frame embeddings).
[arXiv:2212.04356].  32L enc + 32L dec, d_model=1280, 20H (kv=20 — MHA),
d_ff=5120, vocab=51866, biases on attention projections."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    d_model=1280, n_layers=32, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, qkv_bias=True,
    unit=(LayerSpec("attn", "dense"),),
    enc_dec=True, n_encoder_layers=32, encoder_seq=1500,
)
