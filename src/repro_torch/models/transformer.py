"""Block-pattern transformer assembly (the port of
``repro/models/transformer.py``, one device, serving only).

A model is {embedding -> repeating *units* of layers -> final norm -> LM
head}, each layer = {mixer} + {ffn}.  The unit parameters keep the
reference's stacked leading axis (``params["unit"]`` holds one
``(n_units, ...)`` tensor per leaf), and the forward loops over it where
the reference scans.

Ported: the ``attn`` and ``rwkv6`` mixers and the ``dense`` FFN.  The other
mixers and FFNs, unstacked prefix layers, attention logit caps, and the
encoder-decoder and VLM variants raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import LayerSpec, ModelConfig
from . import layers as L
from . import rwkv
from .layers import Ctx
from .params import P, tree_map

_WAITING = {
    "mla": "MLA (ROADMAP queue 1, item 6)",
    "mamba": "Mamba, models/ssm.py (ROADMAP queue 1, item 6)",
    "moe": "MoE, models/moe.py::moe_ref (ROADMAP queue 1, item 6)",
    "enc_dec": "the encoder-decoder variant (ROADMAP queue 1, item 6)",
    "vlm": "the VLM variant (ROADMAP queue 1, item 6)",
    "prefix": "a prefix of unstacked layers (deepseek-moe-16b; ROADMAP queue 1, item 6)",
    "softcap": "an attention logit cap (no config sets one; ROADMAP queue 1, item 6)",
}


def _not_ported(what: str):
    return NotImplementedError(f"{_WAITING[what]} is not ported yet")


def _check_ported(cfg: ModelConfig) -> None:
    for flag in ("enc_dec", "vlm", "prefix"):
        if getattr(cfg, flag):
            raise _not_ported(flag)
    if cfg.attn_logit_softcap:
        raise _not_ported("softcap")
    for spec in cfg.unit:
        if spec.mixer not in ("attn", "rwkv6"):
            raise _not_ported(spec.mixer)
        if spec.ffn != "dense":
            raise _not_ported(spec.ffn)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def layer_param_specs(spec: LayerSpec, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    p: dict = {"mixer_norm": L.rmsnorm_params(d)}
    if spec.mixer == "attn":
        p["mixer"] = L.attn_params(cfg)
    elif spec.mixer == "rwkv6":
        p["mixer"] = rwkv.rwkv_params(cfg)
    else:
        raise _not_ported(spec.mixer)
    p["ffn_norm"] = L.rmsnorm_params(d)
    if spec.ffn != "dense":
        raise _not_ported(spec.ffn)
    p["ffn"] = L.mlp_params(d, cfg.d_ff)
    return p


def _stack(tree, n: int):
    """Add a leading (n,) "layers" axis to every P in the tree."""
    return tree_map(lambda s: P((n,) + s.shape, s.dtype, s.init, s.scale), tree)


def model_param_specs(cfg: ModelConfig, tp: int = 1) -> dict:
    _check_ported(cfg)
    d = cfg.d_model
    V = cfg.padded_vocab(tp)
    p: dict = {
        "embed": P((V, d), init="embed"),
        "final_norm": L.rmsnorm_params(d),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = P((d, V))
    unit = {f"l{i}": layer_param_specs(s, cfg) for i, s in enumerate(cfg.unit)}
    p["unit"] = _stack(unit, cfg.n_units)
    return p


def _unit(tree, i: int):
    """Unit ``i`` of a stacked tree: views, no copies."""
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def apply_layer(spec: LayerSpec, p, x, cfg, ctx: Ctx, *, positions, causal=True):
    """Full-sequence layer.  Returns (x, cache)."""
    h = L.rmsnorm(p["mixer_norm"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        out, (k, v) = L.attn_block(p["mixer"], h, cfg, ctx, positions=positions,
                                   causal=causal)
        cache = {"k": k, "v": v}
    elif spec.mixer == "rwkv6":
        out, cache = rwkv.rwkv6_block(p["mixer"], h, cfg, ctx)
    else:
        raise _not_ported(spec.mixer)
    x = x + out
    h = L.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    return x + L.mlp(p["ffn"], h, ctx), cache


def apply_layer_decode(spec: LayerSpec, p, x, cfg, ctx: Ctx, *, cache, pos: torch.Tensor):
    """One-token layer step; ``pos`` is a one-element ``long`` tensor.
    Returns (x, new_cache)."""
    h = L.rmsnorm(p["mixer_norm"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        out, nc = L.attn_decode_block(p["mixer"], h, cfg, ctx, cache=cache, pos=pos)
    elif spec.mixer == "rwkv6":
        out, nc = rwkv.rwkv6_decode_block(p["mixer"], h, cfg, ctx, cache=cache, pos=pos)
    else:
        raise _not_ported(spec.mixer)
    x = x + out
    h = L.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    return x + L.mlp(p["ffn"], h, ctx), nc


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg, ctx: Ctx):
    return params["embed"][tokens.long()].to(ctx.dtype)


def forward(params, batch, cfg: ModelConfig, ctx: Ctx, *, collect_cache=False):
    """Full-sequence forward to final hidden states.

    batch: {"tokens": (B,S)}.  Returns (hidden, caches); the unit caches are
    stacked on a leading (n_units,) axis, as the reference's scan stacks them.
    """
    _check_ported(cfg)
    x = embed_tokens(params, batch["tokens"], cfg, ctx)
    positions = torch.arange(x.shape[1], device=x.device)
    caches: dict = {}
    per_unit = []
    for u in range(cfg.n_units):
        unit_p = _unit(params["unit"], u)
        unit_caches = {}
        for i, spec in enumerate(cfg.unit):
            x, c = apply_layer(spec, unit_p[f"l{i}"], x, cfg, ctx, positions=positions)
            if collect_cache:
                unit_caches[f"l{i}"] = c
        per_unit.append(unit_caches)
    if collect_cache:
        caches["unit"] = {
            f"l{i}": {name: torch.stack([c[f"l{i}"][name] for c in per_unit])
                      for name in per_unit[0][f"l{i}"]}
            for i in range(len(cfg.unit))}
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), caches


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def _unembed_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def logits_for(params, x_last, cfg, ctx: Ctx):
    """x_last: (B, d) -> (B, V) f32 logits over the padded vocabulary."""
    W = _unembed_matrix(params, cfg)
    return (x_last @ W.to(x_last.dtype)).float()


def prefill(params, batch, cfg, ctx: Ctx, *, cache_len: int | None = None):
    """Run the full prompt, return (cache, last-token logits).

    The attention caches are padded to length ``cache_len`` (>= prompt
    length) so decode can continue in place."""
    hidden, caches = forward(params, batch, cfg, ctx, collect_cache=True)
    S = hidden.shape[1]
    if cache_len is not None:
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} < prompt length {S}")
        if cache_len > S:
            caches = _grow_caches(caches, cache_len - S)
    return caches, logits_for(params, hidden[:, -1], cfg, ctx)


def _grow_caches(caches, extra: int):
    """Zero-pad the sequence axis of every K/V cache buffer by ``extra``
    (fresh tensors: decode writes into them in place)."""

    def walk(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif name in ("k", "v"):          # (..., S, K, hd)
                out[name] = F.pad(leaf, (0, 0, 0, 0, 0, extra))
            else:
                out[name] = leaf
        return out

    return walk(caches)


def _write_back(cache: dict, new: dict) -> None:
    """Store a layer's new cache into the (stacked) buffers it came from."""
    for name, t in new.items():
        if t is not cache[name]:
            cache[name].copy_(t)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, ctx: Ctx):
    """One decode step.  tokens: (B,) ints; pos: write index (the same for
    the whole batch), an ``int`` or a one-element ``long`` tensor on the
    tokens' device.  The cache buffers are updated in place: the serving
    loop owns them.  Returns (logits (B, V), cache).

    Nothing here reads a device value on the host, so with a tensor ``pos``
    the step captures into one CUDA graph (``launch/serve.py``'s
    :class:`~repro_torch.launch.serve.DecodeGraph`); an ``int`` becomes such
    a tensor first, and the same kernels run."""
    if isinstance(pos, torch.Tensor):
        pos = pos.view(1)
    else:
        pos = torch.full((1,), pos, dtype=torch.long, device=tokens.device)
    x = params["embed"][tokens.long()[:, None]].to(ctx.dtype)
    for u in range(cfg.n_units):
        unit_p = _unit(params["unit"], u)
        unit_c = _unit(cache["unit"], u)
        for i, spec in enumerate(cfg.unit):
            x, nc = apply_layer_decode(spec, unit_p[f"l{i}"], x, cfg, ctx,
                                       cache=unit_c[f"l{i}"], pos=pos)
            _write_back(unit_c[f"l{i}"], nc)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_for(params, x[:, 0], cfg, ctx), cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, B: int, S: int) -> dict:
    """Spec tree (P) for a decode cache of capacity S."""
    _check_ported(cfg)
    K, hd = cfg.n_kv_heads, cfg.hd
    H6, N6 = cfg.rwkv_n_heads, cfg.rwkv_head_size

    def one(spec: LayerSpec) -> dict:
        if spec.mixer == "attn":
            return {"k": P((B, S, K, hd), torch.bfloat16, "zeros"),
                    "v": P((B, S, K, hd), torch.bfloat16, "zeros")}
        return {"S": P((B, H6, N6, N6), torch.float32, "zeros"),
                "x_last": P((B, cfg.d_model), torch.bfloat16, "zeros")}

    return {"unit": _stack({f"l{i}": one(s) for i, s in enumerate(cfg.unit)},
                           cfg.n_units)}
