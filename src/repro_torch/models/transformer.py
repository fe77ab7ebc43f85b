"""Block-pattern transformer assembly (the port of
``repro/models/transformer.py``): serving and training on one device or on
a mesh, each process one rank holding its blocks of the parameters (the
contract is :class:`~repro_torch.models.layers.Ctx`'s; :func:`shard_caches`
moves the caches prefill leaves from its layout to the one decode reads).

A model is {embedding -> [prefix layers] -> repeating *units* of layers ->
final norm -> LM head}, each layer = {mixer in attn|mla|mamba|rwkv6} + {ffn
in dense|moe}, plus the optional encoder (Whisper, with cross-attention in
every decoder layer) and the patch-embedding prefix (LLaVA).  The unit
parameters keep the reference's stacked leading axis (``params["unit"]``
holds one ``(n_units, ...)`` tensor per leaf), and the forward loops over
it where the reference scans; prefix layers are unstacked, as there.
Training (:func:`lm_loss`) rematerializes each unit, each encoder layer and
each chunk of the LM head's cross-entropy when ``ctx.remat``, as the
reference's ``jax.checkpoint`` does.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..configs.base import LayerSpec, ModelConfig
from ..parallel import sharding as shd
from ..parallel.sharding import dp_axes
from . import layers as L
from . import moe as M
from . import rwkv, ssm
from .layers import Ctx, _checkpoint, _remat
from .params import P, tree_map

_ENCODER = LayerSpec("attn", "dense")


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def layer_param_specs(spec: LayerSpec, cfg: ModelConfig, tp: int = 1, cross: bool = False
                      ) -> dict:
    d = cfg.d_model
    p: dict = {"mixer_norm": L.rmsnorm_params(d)}
    if spec.mixer == "attn":
        p["mixer"] = L.attn_params(cfg)
    elif spec.mixer == "mla":
        p["mixer"] = L.mla_params(cfg)
    elif spec.mixer == "mamba":
        p["mixer"] = ssm.mamba_params(cfg)
    elif spec.mixer == "rwkv6":
        p["mixer"] = rwkv.rwkv_params(cfg)
    else:
        raise ValueError(spec.mixer)
    if cross:
        p["cross_norm"] = L.rmsnorm_params(d)
        p["cross"] = L.attn_params(cfg)
    p["ffn_norm"] = L.rmsnorm_params(d)
    if spec.ffn == "dense":
        p["ffn"] = L.mlp_params(d, cfg.d_ff)
    else:
        p["ffn"] = M.moe_params(cfg, tp)
    return p


def _stack(tree, n: int):
    """Add a leading (n,) "layers" axis to every P in the tree."""
    return tree_map(lambda s: P((n,) + s.shape, ("layers",) + s.axes, s.dtype, s.init,
                                s.scale), tree)


def model_param_specs(cfg: ModelConfig, tp: int = 1) -> dict:
    d = cfg.d_model
    V = cfg.padded_vocab(tp)
    p: dict = {
        "embed": P((V, d), ("vocab", "embed_fsdp"), init="embed"),
        "final_norm": L.rmsnorm_params(d),
    }
    if not cfg.tie_embeddings:
        # the LM head stays vocab-sharded under every rule set (the
        # vocab-parallel CE depends on it); its d axis stays replicated
        p["unembed"] = P((d, V), (None, "vocab"))
    if cfg.prefix:
        p["prefix"] = {f"p{i}": layer_param_specs(s, cfg, tp, cross=cfg.enc_dec)
                       for i, s in enumerate(cfg.prefix)}
    unit = {f"l{i}": layer_param_specs(s, cfg, tp, cross=cfg.enc_dec)
            for i, s in enumerate(cfg.unit)}
    p["unit"] = _stack(unit, cfg.n_units)
    if cfg.enc_dec:
        p["enc_unit"] = _stack({"l0": layer_param_specs(_ENCODER, cfg, tp)},
                               cfg.n_encoder_layers)
        p["enc_final_norm"] = L.rmsnorm_params(d)
    return p


@functools.lru_cache(maxsize=None)
def _layer_specs(spec: LayerSpec, cfg: ModelConfig, tp: int, cross: bool) -> dict:
    return layer_param_specs(spec, cfg, tp, cross=cross)


def _unit(tree, i: int):
    """Unit ``i`` of a stacked tree: views, no copies."""
    return tree_map(lambda a: a[i], tree)


def _units(tree, n: int) -> list:
    """The ``n`` units of a stacked tree, each a tree of views: one
    ``unbind`` per leaf, so a backward stacks each leaf's ``n`` gradients
    once instead of adding ``n`` full-size ones."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[u], parts) for u in range(n)]


def _stack_trees(trees: list):
    """Stack same-shaped trees of tensors on a new leading axis, as the
    reference's scan stacks each unit's caches."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _mixer_full(spec, p, h, cfg, ctx, positions, causal):
    if spec.mixer == "attn":
        out, (k, v) = L.attn_block(p["mixer"], h, cfg, ctx, positions=positions,
                                   causal=causal)
        return out, {"k": k, "v": v}
    if spec.mixer == "mla":
        out, (lat, kr) = L.mla_block(p["mixer"], h, cfg, ctx, positions=positions)
        return out, {"latent": lat, "k_rope": kr}
    if spec.mixer == "mamba":
        return ssm.mamba_block(p["mixer"], h, cfg, ctx)
    if spec.mixer == "rwkv6":
        return rwkv.rwkv6_block(p["mixer"], h, cfg, ctx)
    raise ValueError(spec.mixer)


def _cross_kv(p, enc_out, cfg, ctx):
    """Cross-attention K/V from the encoder output (no rope; the whole
    encoder sequence, all-gathered under sequence parallelism)."""
    enc_out = ctx.seq_in(enc_out)
    k = L._proj(enc_out, p["wk"])
    v = L._proj(enc_out, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    return k, v


def _cross_attend(p, x, kv, cfg, ctx):
    """q from x (no rope), non-causal attention (K3) over the encoder K/V;
    tensor-parallel as :func:`~repro_torch.models.layers.attn_block`."""
    sharded = L._heads_sharded(cfg, ctx)
    x = ctx.seq_in(x)
    q = L._proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    o = L.attention(q, kv[0], kv[1], causal=False)
    return ctx.seq_out(L._out(o, p["wo"], x.dtype), sharded)


def _ffn(spec, p, h, cfg, ctx, expert_perm=None):
    """-> (out, aux): the dense MLP (aux 0.0) or the MoE with its aux loss."""
    if spec.ffn == "dense":
        return L.mlp(p["ffn"], h, ctx, cfg.d_ff), 0.0
    return M.moe_apply(p["ffn"], h, cfg, ctx, expert_perm=expert_perm)


def apply_layer(spec: LayerSpec, p, x, cfg, ctx: Ctx, *, positions, causal=True,
                enc_out=None, expert_perm=None):
    """Full-sequence layer.  Returns (x, cache, aux); with ``enc_out`` and
    cross-attention weights the cache is {"self": ..., "cross": {"k", "v"}}.
    ``expert_perm`` (logical expert -> physical slot) reaches the
    expert-parallel MoE (:func:`~repro_torch.models.moe.moe_apply`).  With
    ``ctx.rules``, the layer's weights are first gathered where FSDP
    shards them (:meth:`~repro_torch.models.layers.Ctx.gather_params`;
    expert weights stay sharded: the expert-parallel all-to-all owns their
    distribution)."""
    p = ctx.gather_params(p, _layer_specs(spec, cfg, ctx.tp, "cross" in p))
    h = L.rmsnorm(p["mixer_norm"], x, cfg.norm_eps)
    out, cache = _mixer_full(spec, p, h, cfg, ctx, positions, causal)
    x = x + out
    if enc_out is not None and "cross" in p:
        h = L.rmsnorm(p["cross_norm"], x, cfg.norm_eps)
        kv = _cross_kv(p["cross"], enc_out, cfg, ctx)
        x = x + _cross_attend(p["cross"], h, kv, cfg, ctx)
        cache = {"self": cache, "cross": {"k": kv[0], "v": kv[1]}}
    h = L.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    out, aux = _ffn(spec, p, h, cfg, ctx, expert_perm)
    return x + out, cache, aux


def apply_layer_decode(spec: LayerSpec, p, x, cfg, ctx: Ctx, *, cache, pos: torch.Tensor,
                       expert_perm=None):
    """One-token layer step; ``pos`` is a one-element ``long`` tensor.
    Returns (x, new_cache, aux).  On a mesh the layer's weights are first
    gathered where FSDP's ``embed_fsdp`` shards them, as in
    :func:`apply_layer`."""
    p = ctx.gather_params(p, _layer_specs(spec, cfg, ctx.tp, "cross" in p))
    self_cache = cache["self"] if "cross" in p else cache
    h = L.rmsnorm(p["mixer_norm"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        out, nc = L.attn_decode_block(p["mixer"], h, cfg, ctx, cache=self_cache, pos=pos)
    elif spec.mixer == "mla":
        out, nc = L.mla_decode_block(p["mixer"], h, cfg, ctx, cache=self_cache, pos=pos)
    elif spec.mixer == "mamba":
        out, nc = ssm.mamba_decode_block(p["mixer"], h, cfg, ctx, cache=self_cache,
                                         pos=pos)
    elif spec.mixer == "rwkv6":
        out, nc = rwkv.rwkv6_decode_block(p["mixer"], h, cfg, ctx, cache=self_cache,
                                          pos=pos)
    else:
        raise ValueError(spec.mixer)
    x = x + out
    if "cross" in p:
        h = L.rmsnorm(p["cross_norm"], x, cfg.norm_eps)
        ckv = (cache["cross"]["k"], cache["cross"]["v"])
        x = x + _cross_attend(p["cross"], h, ckv, cfg, ctx)
        nc = {"self": nc, "cross": cache["cross"]}
    h = L.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    out, aux = _ffn(spec, p, h, cfg, ctx, expert_perm)
    return x + out, nc, aux


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _encoder(params, enc_embeds, cfg, ctx: Ctx):
    x = enc_embeds.to(ctx.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x = ctx.cs(x, "batch", "seq", "embed")

    def body(x, unit_p):
        return apply_layer(_ENCODER, unit_p["l0"], x, cfg, ctx, positions=positions,
                           causal=False)[0]

    for unit_p in _units(params["enc_unit"], cfg.n_encoder_layers):
        x = _checkpoint(functools.partial(body, unit_p=unit_p), x) if _remat(ctx) \
            else body(x, unit_p)
    return L.rmsnorm(params["enc_final_norm"], x, cfg.norm_eps)


def _vocab_block(W, cfg, ctx: Ctx, dim: int):
    """(W with its non-vocab dims gathered, the first vocab id of the rank's
    block, whether the vocab is split over "model") for the embedding
    (``dim`` 0) or the LM head (``dim`` 1) of the padded vocabulary."""
    V = cfg.padded_vocab(ctx.tp)
    if ctx.mesh is None:
        return W, 0, False
    axes = ("vocab", "embed_fsdp") if dim == 0 else (None, "vocab")
    shape = (V, cfg.d_model) if dim == 0 else (cfg.d_model, V)
    W = ctx.gather_params(W, P(shape, axes))
    split = ctx.tp_sharded("vocab", V)
    return W, (ctx.mesh.axis_index("model") * W.shape[dim] if split else 0), split


def embed_tokens(params, tokens, cfg, ctx: Ctx):
    """The tokens' embeddings.  On a vocab-split table (``rules``) each rank
    looks up the tokens in its block (zeros for the others) and the rows
    are summed over "model".  (This is where the reference's sharded step
    fails on jax 0.9.0: ``jnp.take`` of the vocab-sharded table, ROADMAP
    section 3, fault 5.)"""
    E, v0, split = _vocab_block(params["embed"], cfg, ctx, 0)
    if not split:
        return E[tokens.long()].to(ctx.dtype)
    local = tokens.long() - v0
    mine = (local >= 0) & (local < E.shape[0])
    x = torch.where(mine[..., None], E[local.clamp(0, E.shape[0] - 1)].to(ctx.dtype), 0)
    return ctx.mesh.psum(x, "model")


def forward(params, batch, cfg: ModelConfig, ctx: Ctx, *, collect_cache=False):
    """Full-sequence forward to final hidden states.

    batch: {"tokens": (B,S)} [+ "patch_embeds" (B,P,d) for vlm, placed
    before the text, + "enc_embeds" (B,F,d) for enc_dec].  Returns (hidden,
    caches, aux_total); the unit caches are stacked on a leading (n_units,)
    axis, as the reference's scan stacks them."""
    x = embed_tokens(params, batch["tokens"], cfg, ctx)
    if cfg.vlm:
        x = torch.cat([batch["patch_embeds"].to(ctx.dtype), x], dim=1)
    enc_out = _encoder(params, batch["enc_embeds"], cfg, ctx) if cfg.enc_dec else None
    positions = torch.arange(x.shape[1], device=x.device)
    x = ctx.cs(x, "batch", "seq", "embed")
    aux_total = torch.zeros((), device=x.device)
    caches: dict = {}
    if cfg.prefix:
        caches["prefix"] = {}
        for i, spec in enumerate(cfg.prefix):
            x, c, aux = apply_layer(spec, params["prefix"][f"p{i}"], x, cfg, ctx,
                                    positions=positions, enc_out=enc_out)
            aux_total = aux_total + aux
            if collect_cache:
                caches["prefix"][f"p{i}"] = c

    def unit_body(x, aux_total, unit_p, unit_caches):
        for i, spec in enumerate(cfg.unit):
            x, c, aux = apply_layer(spec, unit_p[f"l{i}"], x, cfg, ctx, positions=positions,
                                    enc_out=enc_out)
            aux_total = aux_total + aux
            if unit_caches is not None:
                unit_caches[f"l{i}"] = c
        return x, aux_total

    per_unit = []
    for unit_p in _units(params["unit"], cfg.n_units):
        if collect_cache:
            per_unit.append({})
            x, aux_total = unit_body(x, aux_total, unit_p, per_unit[-1])
        elif _remat(ctx):
            x, aux_total = _checkpoint(functools.partial(unit_body, unit_p=unit_p,
                                                         unit_caches=None), x, aux_total)
        else:
            x, aux_total = unit_body(x, aux_total, unit_p, None)
    if collect_cache:
        caches["unit"] = _stack_trees(per_unit)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), caches, aux_total


# ---------------------------------------------------------------------------
# chunked cross-entropy LM head
# ---------------------------------------------------------------------------

def _unembed_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def chunked_ce(params, hidden, labels, mask, cfg, ctx: Ctx, chunk: int = 256):
    """Mean CE over masked positions; the logits never exist beyond one
    ``(B, chunk, V)`` slab, recomputed in the backward when ``ctx.remat``.
    Logits of the padded vocabulary are -1e30; ``cfg.logits_softcap`` caps
    them with ``tanh``.  Returns (loss, n_tokens).

    On a mesh (``rules``) the hidden states are the rank's data block (its
    whole sequence, all-gathered under sequence parallelism), the CE is
    vocab-parallel where the LM head's vocab is split over "model" (the
    max and the sum of the exponentials taken over "model", the label's
    logit from the rank that holds it), and the sum of the token losses
    and the token count are summed over the data axes: the loss is
    normalised by the global token count, as the reference's."""
    hidden = ctx.seq_in(hidden)
    B, S, _ = hidden.shape
    W = _unembed_matrix(params, cfg)
    W, v0, split = _vocab_block(W, cfg, ctx, 1)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the CE chunk {chunk}")
    V_loc = W.shape[1]
    vocab_pad = v0 + torch.arange(V_loc, device=hidden.device) >= cfg.vocab
    mesh = ctx.mesh

    def body(h_c, y_c, m_c):
        logits = (h_c @ W.to(h_c.dtype)).float()
        logits = logits.masked_fill(vocab_pad, L.NEG_INF)
        if cfg.logits_softcap:
            logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
        if not split:
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, y_c.long()[..., None])[..., 0]
            return ((lse - ll) * m_c).sum()
        mx = mesh.pmax(logits.amax(dim=-1), "model")
        lse = mesh.psum(torch.exp(logits - mx[..., None]).sum(-1), "model").log() + mx
        local = y_c.long() - v0
        mine = (local >= 0) & (local < V_loc)
        ll = logits.gather(-1, local.clamp(0, V_loc - 1)[..., None])[..., 0]
        ll = mesh.psum(torch.where(mine, ll, 0.0), "model")
        return ((lse - ll) * m_c).sum()

    tot = torch.zeros((), device=hidden.device)
    for c0 in range(0, S, chunk):
        args = (hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk])
        tot = tot + (_checkpoint(body, *args) if _remat(ctx) else body(*args))
    n_tok = mask.sum()
    if mesh is not None:
        for a in dp_axes(mesh):
            tot, n_tok = mesh.psum(tot, a), mesh.psum(n_tok, a)
    n_tok = n_tok.clamp_min(1.0)
    return tot / n_tok, n_tok


def lm_loss(params, batch, cfg: ModelConfig, ctx: Ctx):
    """Next-token CE + the MoE aux loss.  batch needs "tokens" and "labels"
    (+ the modality extras); a label of -100 is masked, and the VLM's patch
    positions carry none.  Returns (total, {"ce", "aux", "n_tok"})."""
    hidden, _, aux = forward(params, batch, cfg, ctx)
    labels = batch["labels"]
    if cfg.vlm:
        pad = torch.full((labels.shape[0], batch["patch_embeds"].shape[1]), -100,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    mask = (labels >= 0).float()
    loss, n_tok = chunked_ce(params, hidden, labels.clamp_min(0), mask, cfg, ctx)
    total = loss + cfg.router_aux_coef * aux
    return total, {"ce": loss, "aux": aux, "n_tok": n_tok}


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def logits_for(params, x_last, cfg, ctx: Ctx):
    """x_last: (B, d) -> (B, V) f32 logits over the padded vocabulary; on a
    vocab-split LM head each rank's block, all-gathered over "model"."""
    W, _, split = _vocab_block(_unembed_matrix(params, cfg), cfg, ctx, 1)
    logits = (x_last @ W.to(x_last.dtype)).float()
    return ctx.mesh.all_gather(logits, "model", 1) if split else logits


def prefill(params, batch, cfg, ctx: Ctx, *, cache_len: int | None = None):
    """Run the full prompt, return (cache, last-token logits).

    The self-attention caches are padded to length ``cache_len`` (>= the
    sequence's length, the VLM's patches included) so decode can continue
    in place.  On a mesh they are in the prefill's layout (each rank's
    heads of its data block; :func:`shard_caches` moves them to decode's)."""
    hidden, caches, _ = forward(params, batch, cfg, ctx, collect_cache=True)
    x_last = hidden[:, -1:]
    if ctx.seq_parallel:                    # the last position is on the last rank
        x_last = ctx.mesh.all_gather(x_last, "model", 1)[:, -1:]
    S = batch["tokens"].shape[1] + (batch["patch_embeds"].shape[1] if cfg.vlm else 0)
    if cache_len is not None:
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} < prompt length {S} (incl. modality "
                             f"prefix tokens)")
        if cache_len > S:
            caches = _grow_caches(caches, cache_len - S)
    return caches, logits_for(params, x_last[:, 0], cfg, ctx)


def _grow_caches(caches, extra: int):
    """Zero-pad the sequence axis of every sequence-indexed cache buffer by
    ``extra`` (fresh tensors: decode writes into them in place).  The
    cross-attention caches (the fixed encoder length) and the recurrent
    states (RWKV-6's ``S`` and ``x_last``, Mamba's ``h`` and ``conv``) are
    left untouched."""

    def walk(tree):
        out = {}
        for name, leaf in tree.items():
            if name == "cross":
                out[name] = leaf
            elif isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif name in ("k", "v"):          # (..., S, K, hd)
                out[name] = F.pad(leaf, (0, 0, 0, 0, 0, extra))
            elif name in ("latent", "k_rope"):  # (..., S, r)
                out[name] = F.pad(leaf, (0, 0, 0, extra))
            else:
                out[name] = leaf
        return out

    return walk(caches)


def shard_caches(caches, specs, mesh, src_rules, dst_rules):
    """The caches of a prefill on ``mesh``, each rank's blocks under
    ``src_rules`` (the prefill's: the rank's heads, the whole sequence),
    moved to its blocks under ``dst_rules`` (decode's: under
    ``DECODE_RULES`` each attention cache is the rank's sequence shard,
    holding every key/value head): one all-to-all over "model" a cache that
    moves its split from the heads to the sequence, a slice where it was
    whole (MLA's latent cache), nothing where the split stays (the
    recurrent states, the cross-attention caches).  ``specs`` is the cache
    spec tree (:func:`cache_specs`) whose logical axes name each leaf's
    dimensions; the batch is laid out alike under both rule sets and does
    not move."""
    tp = mesh.shape.get("model", 1)

    def one(x, spec):
        src = shd.spec_for(spec.axes, src_rules, mesh)
        # the global shape where "model" matters (its batch dimension is the
        # rank's block, which places only the data axes)
        shape = [n * tp if "model" in shd.entry_axes(e) else n
                 for n, e in zip(x.shape, src + (None,) * x.dim())]
        src = shd.spec_for(spec.axes, src_rules, mesh, shape)
        dst = shd.spec_for(spec.axes, dst_rules, mesh, shape)
        return shd.reshard(x, src, dst, mesh)

    return tree_map(one, caches, specs)


def _write_back(cache: dict, new: dict) -> None:
    """Store a layer's new cache into the buffers it came from."""
    for name, t in new.items():
        if isinstance(t, dict):
            _write_back(cache[name], t)
        elif t is not cache[name]:
            cache[name].copy_(t)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, ctx: Ctx, *, expert_perm=None):
    """One decode step.  tokens: (B,) ints; pos: write index (the same for
    the whole batch), an ``int`` or a one-element ``long`` tensor on the
    tokens' device.  The cache buffers are updated in place: the serving
    loop owns them.  Returns (logits (B, V), cache).  ``expert_perm`` is
    :func:`apply_layer`'s.

    Nothing here reads a device value on the host, so with a tensor ``pos``
    the step captures into one CUDA graph (``launch/serve.py``'s
    :class:`~repro_torch.launch.serve.DecodeGraph`); an ``int`` becomes such
    a tensor first, and the same kernels run."""
    if isinstance(pos, torch.Tensor):
        pos = pos.view(1)
    else:
        pos = torch.full((1,), pos, dtype=torch.long, device=tokens.device)
    x = embed_tokens(params, tokens[:, None], cfg, ctx)
    for i, spec in enumerate(cfg.prefix):
        c = cache["prefix"][f"p{i}"]
        x, nc, _ = apply_layer_decode(spec, params["prefix"][f"p{i}"], x, cfg, ctx,
                                      cache=c, pos=pos, expert_perm=expert_perm)
        _write_back(c, nc)
    for u in range(cfg.n_units):
        unit_p = _unit(params["unit"], u)
        unit_c = _unit(cache["unit"], u)
        for i, spec in enumerate(cfg.unit):
            x, nc, _ = apply_layer_decode(spec, unit_p[f"l{i}"], x, cfg, ctx,
                                          cache=unit_c[f"l{i}"], pos=pos,
                                          expert_perm=expert_perm)
            _write_back(unit_c[f"l{i}"], nc)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_for(params, x[:, 0], cfg, ctx), cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, B: int, S: int, tp: int = 1) -> dict:
    """Spec tree (P) for a decode cache of capacity S.  ``tp`` is the
    reference's argument, which it does not read either: the config is the
    one already padded for it (:func:`repro_torch.configs.base.pad_for_tp`)."""
    K, hd = cfg.n_kv_heads, cfg.hd
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    H6, N6 = cfg.rwkv_n_heads, cfg.rwkv_head_size
    bf16 = torch.bfloat16

    def one(spec: LayerSpec) -> dict:
        if spec.mixer == "attn":
            kv = ("batch", "cache_seq", "kv_heads", "head_dim")
            c = {"k": P((B, S, K, hd), kv, bf16, "zeros"),
                 "v": P((B, S, K, hd), kv, bf16, "zeros")}
        elif spec.mixer == "mla":
            lat = ("batch", "cache_seq", None)
            c = {"latent": P((B, S, cfg.kv_lora_rank), lat, bf16, "zeros"),
                 "k_rope": P((B, S, cfg.qk_rope_dim), lat, bf16, "zeros")}
        elif spec.mixer == "mamba":
            c = {"h": P((B, di, ds), ("batch", "mamba_inner", None), torch.float32, "zeros"),
                 "conv": P((B, cfg.mamba_d_conv - 1, di), ("batch", None, "mamba_inner"), bf16,
                           "zeros")}
        elif spec.mixer == "rwkv6":
            c = {"S": P((B, H6, N6, N6), ("batch", "rwkv_heads", None, None), torch.float32,
                        "zeros"),
                 "x_last": P((B, cfg.d_model), ("batch", None), bf16, "zeros")}
        else:
            raise ValueError(spec.mixer)
        if cfg.enc_dec:
            ckv = ("batch", None, "kv_heads", "head_dim")
            c = {"self": c,
                 "cross": {"k": P((B, cfg.encoder_seq, K, hd), ckv, bf16, "zeros"),
                           "v": P((B, cfg.encoder_seq, K, hd), ckv, bf16, "zeros")}}
        return c

    out: dict = {}
    if cfg.prefix:
        out["prefix"] = {f"p{i}": one(s) for i, s in enumerate(cfg.prefix)}
    out["unit"] = _stack({f"l{i}": one(s) for i, s in enumerate(cfg.unit)}, cfg.n_units)
    return out
