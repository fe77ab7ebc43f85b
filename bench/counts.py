"""The benchmark's own operation and byte counts, from shapes alone.

Every count is what the algorithm needs for the call, not what a kernel
happens to do: matrix-product FLOPs (2 a multiply-add), attention over the
key/query pairs a causal mask keeps, each input byte read once and each
output byte written once.  Norms, rotary embeddings and other elementwise
work are left out of the FLOPs (they are a fraction of a percent of them).
A share of a roofline is the least time these counts allow, at the peaks
below, over a measured time: it cannot pass 100% unless a count is too high
or the time leaves out part of the work.

The geometry comes from a configuration file of ``bench/configs`` (its
``config`` object, Hugging Face keys), never from the program.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM, the data sheet's dense rates (no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class Geometry:
    d: int            # hidden size
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int        # the published vocabulary (logits and labels range over it)
    d_ff: int = 0     # dense MLP width (0: the FFN is a mixture of experts)
    experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    tied: bool = True

    @property
    def moe(self) -> bool:
        return self.experts > 0

    def attn_params(self) -> int:
        """wq, wk, wv and wo of one layer."""
        hd = self.head_dim
        return 2 * self.d * self.heads * hd + 2 * self.d * self.kv_heads * hd

    def ffn_params(self) -> int:
        """Every FFN weight of one layer (all experts and the router)."""
        if self.moe:
            return self.experts * 3 * self.d * self.expert_ff + self.d * self.experts
        return 3 * self.d * self.d_ff

    def ffn_active(self) -> int:
        """FFN weights one token multiplies by: its routed experts and the router."""
        if self.moe:
            return self.top_k * 3 * self.d * self.expert_ff + self.d * self.experts
        return 3 * self.d * self.d_ff

    def params(self) -> int:
        """Every parameter: layers (with their two norm scales), the
        embedding, the final norm, and an untied LM head."""
        per_layer = self.attn_params() + self.ffn_params() + 2 * self.d
        head = 0 if self.tied else self.d * self.vocab
        return self.layers * per_layer + self.vocab * self.d + self.d + head

    def active_matmul(self) -> int:
        """Weights one token multiplies by in the layers (no LM head)."""
        return self.layers * (self.attn_params() + self.ffn_active())


def geometry(config: dict) -> Geometry:
    """A :class:`Geometry` from a configuration's Hugging Face keys."""
    d, heads = config["hidden_size"], config["num_attention_heads"]
    experts = config.get("num_local_experts", 0)
    return Geometry(
        d=d, layers=config["num_hidden_layers"], heads=heads,
        kv_heads=config.get("num_key_value_heads", heads),
        head_dim=config.get("head_dim") or d // heads, vocab=config["vocab_size"],
        d_ff=0 if experts else config["intermediate_size"], experts=experts,
        top_k=config.get("num_experts_per_tok", 0),
        expert_ff=config["intermediate_size"] if experts else 0,
        tied=config.get("tie_word_embeddings", False))


def kept_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs one head scores; causal: query i (from position
    0) sees keys 0..i."""
    if not causal:
        return sq * sk
    full = min(sq, sk)
    return full * (full + 1) // 2 + (sq - full) * sk


def roofline_s(flops: float, nbytes: float, flop_rate: float = PEAK_BF16_FLOPS,
               byte_rate: float = PEAK_HBM_BYTES) -> float:
    """The least seconds the card could take: the larger of the two."""
    return max(flops / flop_rate, nbytes / byte_rate)


def k3_counts(b: int, h: int, k: int, sq: int, sk: int, hd: int,
              causal: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash-attention forward: 4 hd operations a
    kept pair (q k and p v); q, k, v read and o written once."""
    flops = 4 * hd * kept_pairs(sq, sk, causal) * b * h
    nbytes = BF16 * hd * (2 * b * h * sq + 2 * b * k * sk)
    return flops, nbytes


def k3b_counts(b: int, h: int, k: int, sq: int, sk: int, hd: int,
               causal: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash-attention backward: 10 hd operations a
    kept pair (q k, dO v, dS k, dS q, P dO, with P recomputed); q, k, v, o,
    dO and the f32 row statistics read, dq, dk, dv written."""
    flops = 10 * hd * kept_pairs(sq, sk, causal) * b * h
    nbytes = BF16 * hd * (4 * b * h * sq + 4 * b * k * sk) + F32 * b * h * sq
    return flops, nbytes


def k3_bound_s(*shape, causal: bool) -> float:
    return roofline_s(*k3_counts(*shape, causal=causal))


def k3b_bound_s(*shape, causal: bool) -> float:
    return roofline_s(*k3b_counts(*shape, causal=causal))


def _attn_layer_flops(g: Geometry, b: int, sq: int, sk: int, causal: bool) -> float:
    return k3_counts(b, g.heads, g.kv_heads, sq, sk, g.head_dim, causal)[0]


def prefill_counts(g: Geometry, b: int, s: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one prefill of ``b`` prompts of ``s`` tokens in
    bf16: every layer's products on every token (the routed experts only),
    causal attention, the LM head on each prompt's last position.  Bytes:
    every weight once (every expert: ``b s k`` routes reach all of them),
    the tokens, the key/value cache written, the f32 logits."""
    flops = (2 * g.active_matmul() * b * s + g.layers * _attn_layer_flops(g, b, s, s, True)
             + 2 * g.d * g.vocab * b)
    kv = g.layers * 2 * b * s * g.kv_heads * g.head_dim * BF16
    nbytes = BF16 * g.params() + 4 * b * s + kv + F32 * b * g.vocab
    return flops, nbytes


def decode_step_counts(g: Geometry, b: int, pos: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode step of ``b`` rows writing position
    ``pos`` (so attending over ``pos + 1`` keys), bf16: the products of
    one token a row, attention, the LM head.  Bytes: every weight once,
    the cache read up to ``pos`` and the new key and value written, the
    f32 logits."""
    flops = (2 * (g.active_matmul() + g.d * g.vocab) * b
             + g.layers * _attn_layer_flops(g, b, 1, pos + 1, False))
    kv = g.layers * 2 * b * (pos + 1) * g.kv_heads * g.head_dim * BF16
    nbytes = BF16 * g.params() + kv + 4 * b + F32 * b * g.vocab
    return flops, nbytes


def train_step_flops(g: Geometry, b: int, s: int) -> float:
    """Model FLOPs of one training step on ``b`` sequences of ``s``: 6 a
    token for every weight it multiplies by (the LM head too: forward 2,
    backward 4), and causal attention forward (4 hd a kept pair) and
    backward (8 hd).  Recomputation under remat is not counted."""
    n = g.active_matmul() + g.d * g.vocab
    attn = 3 * g.layers * _attn_layer_flops(g, b, s, s, True)
    return 6 * n * b * s + attn
