"""Architecture registry and random batches (the port of
``repro/configs/registry.py``, without its ``jax`` stand-ins).

``get_config(name)`` returns the exact published geometry; ``make_batch``
draws real tensors from an explicit :class:`torch.Generator`.
"""

from __future__ import annotations

import importlib

import torch

from .base import ModelConfig

ARCH_IDS = [
    "rwkv6_3b",
    "whisper_large_v3",
    "command_r_35b",
    "granite_3_2b",
    "minitron_4b",
    "minicpm3_4b",
    "llava_next_mistral_7b",
    "jamba_1_5_large_398b",
    "granite_moe_3b_a800m",
    "deepseek_moe_16b",
]


# CLI aliases with dashes/dots
def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"{__package__}.{canon(name)}")
    return mod.CONFIG


def make_batch(cfg: ModelConfig, seq: int, batch: int, *, train: bool,
               generator: torch.Generator) -> dict:
    """A random batch of ``seq`` positions on the generator's device, drawn
    in the reference's order: for the VLM ``patch_embeds`` ``(batch,
    n_patches, d)`` and ``seq - n_patches`` text tokens, for the
    encoder-decoder ``enc_embeds`` ``(batch, encoder_seq, d)`` (both
    ``normal x 0.02`` in bf16), then int32 ``tokens`` in ``[0, vocab)`` (and
    ``labels`` when ``train``)."""
    device = generator.device
    embeds = []
    s_text = seq
    if cfg.vlm:
        s_text = seq - cfg.n_patches
        embeds.append(("patch_embeds", (batch, cfg.n_patches, cfg.d_model)))
    if cfg.enc_dec:
        embeds.append(("enc_embeds", (batch, cfg.encoder_seq, cfg.d_model)))
    out = {name: (torch.randn(shape, generator=generator, device=device) * 0.02).to(
        torch.bfloat16) for name, shape in embeds}
    for name in ("tokens", "labels") if train else ("tokens",):
        out[name] = torch.randint(0, cfg.vocab, (batch, s_text), generator=generator,
                                  device=device, dtype=torch.int32)
    return out
