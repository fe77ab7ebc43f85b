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
    """Random int32 tokens in ``[0, vocab)`` of a ``(batch, seq)`` batch (and
    labels when ``train``), on the generator's device.  The VLM and
    encoder-decoder inputs are not drawn: those variants are not ported."""
    names = ("tokens", "labels") if train else ("tokens",)
    return {name: torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                                device=generator.device, dtype=torch.int32)
            for name in names}
