"""Model/shape configuration: the port's copy of the reference's
``ModelConfig`` and ``LayerSpec`` (``repro/configs/base.py``).

A :class:`ModelConfig` fully describes one architecture: geometry, the layer
*pattern* (which mixer / which ffn per layer, expressed as a repeating unit
with its parameters stacked on a leading axis), MoE/MLA/SSM hyperparameters
and numerics.  The 10 assigned architectures live in sibling modules,
registered in :mod:`repro_torch.configs.registry`.  The classes are copied
verbatim, so every config equals the reference's field for field; so are
the assigned input shapes (:data:`SHAPES`) the dry run lowers.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "mla", "mamba", "rwkv6"]
Ffn = Literal["dense", "moe"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    ffn: Ffn = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # layer pattern: prefix layers (not scanned) + scan unit x n_units
    # n_layers == len(prefix) + len(unit) * n_units  must hold.
    prefix: tuple[LayerSpec, ...] = ()
    unit: tuple[LayerSpec, ...] = (LayerSpec(),)

    # attention
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    router_aux_coef: float = 0.01

    # MLA (MiniCPM3 / DeepSeek-V2 style)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # Mamba (Jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # RWKV6
    rwkv_head_size: int = 64
    rwkv_heads_pad: int = 0          # set by pad_for_tp; 0 = derive from d

    # encoder-decoder (Whisper backbone)
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # Whisper: fixed 1500 frames (30 s)

    # VLM (LLaVA backbone): patch embeddings are precomputed stubs
    vlm: bool = False
    n_patches: int = 576             # one 24x24 anyres tile

    # numerics / fitting
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    optstate_dtype: str = "float32"  # bf16 for the 398B to fit one pod
    fsdp: bool = False               # additionally shard big weights over data
    remat: bool = True
    logits_softcap: float = 0.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # long_500k applicability: sub-quadratic decode path exists?
    subquadratic: bool = False

    # ---- derived -----------------------------------------------------------
    def __post_init__(self):
        rem = self.n_layers - len(self.prefix)
        assert rem >= 0 and rem % len(self.unit) == 0, (
            self.name, self.n_layers, len(self.prefix), len(self.unit))

    @property
    def n_units(self) -> int:
        return (self.n_layers - len(self.prefix)) // len(self.unit)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def rwkv_n_heads(self) -> int:
        return self.rwkv_heads_pad or self.d_model // self.rwkv_head_size

    def padded(self, n: int, multiple: int) -> int:
        return ((n + multiple - 1) // multiple) * multiple

    def padded_vocab(self, model_shards: int = 16, lane: int = 128) -> int:
        """Vocab padded so TP shards are lane-aligned (multiple of shards*lane)."""
        return self.padded(self.vocab, max(model_shards, 1) * lane)

    def layer_specs(self) -> tuple[LayerSpec, ...]:
        return self.prefix + self.unit * self.n_units

    @property
    def has_attention(self) -> bool:
        return any(l.mixer in ("attn", "mla") for l in self.layer_specs())

    @property
    def has_moe(self) -> bool:
        return any(l.ffn == "moe" for l in self.layer_specs())

    def attn_layer_count(self) -> int:
        return sum(1 for l in self.layer_specs() if l.mixer in ("attn", "mla"))

    # ---- reduced config for CPU smoke tests --------------------------------
    def smoke(self) -> "ModelConfig":
        """Tiny same-family config: few layers, small width, small vocab."""
        unit = self.unit
        prefix = self.prefix
        n_layers = len(prefix) + len(unit)  # one scan unit
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            d_model=128,
            n_layers=n_layers,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab=512,
            head_dim=32,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            q_lora_rank=48 if self.q_lora_rank else 0,
            qk_nope_dim=16 if self.qk_nope_dim else 0,
            qk_rope_dim=16 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            rwkv_head_size=32,
            n_encoder_layers=len(unit) if self.enc_dec else 0,
            encoder_seq=16 if self.enc_dec else self.encoder_seq,
            n_patches=8 if self.vlm else self.n_patches,
            param_dtype="float32",
            activation_dtype="float32",
            fsdp=False,
        )


def pad_for_tp(cfg: "ModelConfig", tp: int) -> "ModelConfig":
    """Pad head counts to the tensor-parallel degree — the standard
    Megatron/vLLM scheme for TP > kv_heads (q heads rounded up, kv heads
    rounded up as heads of their own).  tp=1 is the identity, so one device
    sees the published geometry; a padded config is another model, whose
    extra heads are drawn like the others."""
    if tp <= 1:
        return cfg
    up = lambda n: ((n + tp - 1) // tp) * tp  # noqa: E731
    H = up(cfg.n_heads)
    K = H if cfg.n_kv_heads == cfg.n_heads else up(cfg.n_kv_heads)
    rwkv_pad = up(cfg.rwkv_n_heads)
    if (H, K, rwkv_pad) == (cfg.n_heads, cfg.n_kv_heads, cfg.rwkv_n_heads):
        return cfg
    # freeze head_dim before padding head counts (it may be derived from d)
    return dataclasses.replace(cfg, head_dim=cfg.hd, n_heads=H, n_kv_heads=K,
                               rwkv_heads_pad=rwkv_pad)


# The assigned input-shape set (LM family): seq_len x global_batch ------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs; reason if skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skip: pure full-attention arch — 512k dense-attention "
                       "decode has no sub-quadratic path in published form")
    return True, ""
