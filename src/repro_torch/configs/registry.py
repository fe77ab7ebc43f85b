"""Architecture registry and random batches (the port of
``repro/configs/registry.py``, without its ``jax`` stand-ins).

``get_config(name)`` returns the exact published geometry (``arch+variant``:
with the fields of :data:`VARIANTS`); ``make_batch`` draws real tensors from
an explicit :class:`torch.Generator`.
"""

from __future__ import annotations

import dataclasses
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


# configurations the published ones do not cover: ``arch+variant`` is the
# published config of ``arch`` with these fields set.  "softcap": the
# attention and final logit caps Gemma 2 publishes (attn_logit_softcapping
# 50.0 and final_logit_softcapping 30.0 in its configs)
VARIANTS = {"softcap": dict(attn_logit_softcap=50.0, logits_softcap=30.0)}
# the same variants in a cut of a few layers whose weights are drawn at init,
# checked against another implementation: there the scaled attention logits
# and the output logits stay within a few units (~1.2 and ~0.8 in the reduced
# granite), where caps of 50 and 30 move them by about a parity tolerance;
# caps of 0.5 saturate them
CUT_VARIANTS = {"softcap": dict(attn_logit_softcap=0.5, logits_softcap=0.5)}


def split_variant(name: str, cut: bool = False) -> tuple[str, dict]:
    """``arch+variant`` -> (arch, the fields the variant sets: those of
    :data:`VARIANTS`, or of :data:`CUT_VARIANTS` where ``cut``); a name
    without ``+`` -> (name, {})."""
    arch, _, variant = name.partition("+")
    return arch, (dict((CUT_VARIANTS if cut else VARIANTS)[variant]) if variant else {})


def get_config(name: str) -> ModelConfig:
    arch, fields = split_variant(name)
    cfg = importlib.import_module(f"{__package__}.{canon(arch)}").CONFIG
    if fields:
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}+{name.partition('+')[2]}", **fields)
    return cfg


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
