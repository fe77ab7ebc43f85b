"""Architecture registry, input specs and random batches (the port of
``repro/configs/registry.py``).

``get_config(name)`` returns the exact published geometry (``arch+variant``:
with the fields of :data:`VARIANTS`); ``input_specs`` returns ``meta``
tensors (the dry run's stand-ins: shapes and dtypes, no allocation) and
``make_batch`` real tensors drawn from an explicit :class:`torch.Generator`,
for each assigned shape.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable

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


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def _batch_shapes(cfg: ModelConfig, seq: int, batch: int, with_labels: bool) -> dict:
    """name -> (shape, dtype) for a full-sequence batch of ``seq`` positions."""
    out: dict = {}
    s_text = seq
    if cfg.vlm:
        s_text = seq - cfg.n_patches
        out["patch_embeds"] = ((batch, cfg.n_patches, cfg.d_model), torch.bfloat16)
    if cfg.enc_dec:
        out["enc_embeds"] = ((batch, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    out["tokens"] = ((batch, s_text), torch.int32)
    if with_labels:
        out["labels"] = ((batch, s_text), torch.int32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The global batch of a train or prefill shape as ``meta`` tensors
    (decode cells build their cache specs with ``transformer.cache_specs``)."""
    shapes = _batch_shapes(cfg, shape.seq_len, shape.global_batch,
                           with_labels=shape.kind == "train")
    return {k: torch.empty(s, dtype=d, device="meta") for k, (s, d) in shapes.items()}


def cells(arch_ids=None, shape_names=None):
    """All (arch, shape, applicable, reason) cells in assignment order."""
    out = []
    for a in (arch_ids or ARCH_IDS):
        cfg = get_config(a)
        for s in (shape_names or SHAPES):
            ok, reason = shape_applicable(cfg, SHAPES[s])
            out.append((a, s, ok, reason))
    return out


def make_batch(cfg: ModelConfig, seq: int, batch: int, *, train: bool,
               generator: torch.Generator) -> dict:
    """A random batch of ``seq`` positions on the generator's device, drawn
    in the reference's order: for the VLM ``patch_embeds`` ``(batch,
    n_patches, d)`` and ``seq - n_patches`` text tokens, for the
    encoder-decoder ``enc_embeds`` ``(batch, encoder_seq, d)`` (both
    ``normal x 0.02`` in bf16), then int32 ``tokens`` in ``[0, vocab)`` (and
    ``labels`` when ``train``)."""
    device = generator.device
    out = {}
    for name, (shape, dtype) in _batch_shapes(cfg, seq, batch, with_labels=train).items():
        if dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab, shape, generator=generator, device=device,
                                      dtype=dtype)
        else:
            out[name] = (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)
    return out
