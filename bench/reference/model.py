"""The plain reference: a decoder-only GQA transformer with a SwiGLU MLP or
a top-k mixture of experts, in plain PyTorch, float32 with TF32 off.

It follows the published Llama-style description that Granite 3.0 uses
(RMSNorm before attention and FFN, rotary embeddings in the rotate-half
form, grouped-query attention scaled by 1/sqrt(head_dim), SwiGLU, tied
embeddings), with the configuration file's departures: no Granite
multipliers.  It imports nothing of the program.  Weights come as the
benchmark drew them, in a tree whose layout is a checkpoint format:
``embed`` (vocab rows, d), ``final_norm/scale``, and under ``unit/l0`` one
tensor a leaf stacked over the layers (``mixer/wq`` (L, d, H, hd), ``wk``,
``wv`` (L, d, K, hd), ``wo`` (L, H, hd, d), the norms' ``scale`` (L, d),
``ffn/wi_gate``, ``wi_up`` (L, d, F), ``wo`` (L, F, d), or for experts
``ffn/router`` (L, d, E), ``w_gate``, ``w_up`` (L, E, d, F), ``w_down``
(L, E, F, d)).  Each layer's weights are upcast to float32 as it runs.

``precision="fp8"`` is the control: every matrix product's two operands
rounded to float8 e4m3 with one scale a tensor (its largest magnitude at
448), the product in float32 — the step below the bf16 the served
configuration states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in float32 (the card would otherwise be free to
    round their inputs to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    elif precision != "f32":
        raise ValueError(f"precision {precision!r}")
    return a @ b


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x (B, S, heads, hd) at positions 0..S-1, rotate-half form."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float64) / hd)
    ang = torch.arange(s, device=x.device, dtype=torch.float64)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, precision: str):
    """Causal grouped-query attention: q (B, S, H, hd), k, v (B, S, K, hd);
    query head h reads key/value head h // (H / K).  Queries in chunks, so
    that one chunk's scores stay near 2**28 floats (1 GiB)."""
    b, s, h, hd = q.shape
    q_chunk = max(1, 2**28 // (b * h * s))
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)      # (B, H, S, hd)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = torch.empty_like(q)
    keys = torch.arange(s, device=q.device)
    for c0 in range(0, s, q_chunk):
        qc = q[:, :, c0:c0 + q_chunk]
        c1 = c0 + qc.shape[2]           # these rows see keys 0..c1-1 at most
        scores = mm(qc, k[:, :, :c1].transpose(-1, -2), precision) / math.sqrt(hd)
        rows = torch.arange(c0, c1, device=q.device)
        scores = scores.masked_fill(keys[None, :c1] > rows[:, None], float("-inf"))
        out[:, :, c0:c1] = mm(torch.softmax(scores, -1), v[:, :, :c1], precision)
    return out.transpose(1, 2)


def dense_ffn(x, w, precision):
    h = F.silu(mm(x, w["wi_gate"], precision)) * mm(x, w["wi_up"], precision)
    return mm(h, w["wo"], precision)


def moe_ffn(x, w, top_k: int, precision):
    """Top-k routing over softmax probabilities, the k weights renormalised
    to sum to 1; each expert runs on the tokens routed to it."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    probs = torch.softmax(mm(x, w["router"], precision), -1)
    wt, idx = torch.topk(probs, top_k, dim=-1)
    wt = wt / wt.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(w["w_gate"].shape[0]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        he = F.silu(mm(xe, w["w_gate"][e], precision)) * mm(xe, w["w_up"][e], precision)
        out.index_add_(0, rows, mm(he, w["w_down"][e], precision) * wt[rows, slot, None])
    return out.reshape(shape)


def _layer(tree, i: int) -> dict:
    """Layer ``i``'s weights in float32, matrices flattened to 2-D."""
    u = tree["unit"]["l0"]
    m, f = u["mixer"], u["ffn"]
    d = m["wq"].shape[1]
    w = {"attn_norm": u["mixer_norm"]["scale"][i].float(),
         "ffn_norm": u["ffn_norm"]["scale"][i].float(),
         "wq": m["wq"][i].float().reshape(d, -1), "wk": m["wk"][i].float().reshape(d, -1),
         "wv": m["wv"][i].float().reshape(d, -1),
         "wo": m["wo"][i].float().reshape(-1, d)}
    w["ffn"] = {k: t[i].float() for k, t in f.items()}
    return w


def hidden_states(tree, config: dict, tokens: torch.Tensor, precision: str = "f32"
                  ) -> torch.Tensor:
    """Final-normed hidden states (B, S, d) in float32 of ``tokens`` (B, S)."""
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    heads, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or config["hidden_size"] // heads
    b, s = tokens.shape
    x = tree["embed"][tokens.long()].float()
    for i in range(config["num_hidden_layers"]):
        w = _layer(tree, i)
        h = rmsnorm(x, w["attn_norm"], eps)
        q = rope(mm(h, w["wq"], precision).view(b, s, heads, hd), theta)
        k = rope(mm(h, w["wk"], precision).view(b, s, kv, hd), theta)
        v = mm(h, w["wv"], precision).view(b, s, kv, hd)
        o = attention(q, k, v, precision).reshape(b, s, heads * hd)
        x = x + mm(o, w["wo"], precision)
        h = rmsnorm(x, w["ffn_norm"], eps)
        if "router" in w["ffn"]:
            x = x + moe_ffn(h, w["ffn"], config["num_experts_per_tok"], precision)
        else:
            x = x + dense_ffn(h, w["ffn"], precision)
        del w, h, q, k, v, o
    return rmsnorm(x, tree["final_norm"]["scale"].float(), eps)


def logits_at(tree, config: dict, tokens: torch.Tensor, first: int,
              precision: str = "f32") -> torch.Tensor:
    """Logits (B, S - first, vocab) in float32 that positions ``first``..S-1
    of ``tokens`` (B, S) give for the next token, over the published
    vocabulary."""
    x = hidden_states(tree, config, tokens, precision)[:, first:]
    emb = tree["embed"][:config["vocab_size"]].float()
    return mm(x, emb.T, precision)


def served_gaps(tree, config: dict, prompts: torch.Tensor, served: torch.Tensor,
                precision: str = "f32", control: bool = False) -> torch.Tensor:
    """The greedy check of served requests.  ``prompts`` (n, S) and the
    tokens served after them ``served`` (n, D + 1), the first from the
    prefill.  The reference reads each prompt with its served tokens and at
    each served position takes the gap by which the served token's logit
    lies below its best (infinite for an id past the vocabulary): (n, D + 1).

    ``control``: the tokens judged are not the served ones but those the
    reference in ``precision`` puts first at the same positions, judged by
    the float32 logits."""
    no_tf32()
    s = prompts.shape[1]
    # a served id past the vocabulary already fails; as context it is read
    # as the last id, so that the other positions are still judged
    context = served[:, :-1].long().clamp_max(config["vocab_size"] - 1)
    tokens = torch.cat([prompts.long(), context], dim=1)
    with torch.no_grad():
        ref = logits_at(tree, config, tokens, s - 1, "f32")
        best = ref.amax(-1)
        if control:
            pick = logits_at(tree, config, tokens, s - 1, precision).argmax(-1)
        else:
            pick = served.long()
        inside = pick < ref.shape[-1]
        got = ref.gather(-1, pick.clamp_max(ref.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, best - got, torch.full_like(best, float("inf")))
