"""The plain reference of the training step, in float32 with TF32 off.

The forward is ``reference.model``'s, each layer and each chunk of
attention queries and of the LM head recomputed in the backward so that a
2.5B-parameter model's step at 16,384 tokens fits beside its optimizer
state; the loss is the mean next-token cross entropy over the published
vocabulary; the gradients come from autograd; the update is AdamW with
global-norm clipping and a linear warm-up, as the traffic file states
(``optimizer``).  It imports nothing of the program and takes the weights
the benchmark drew."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import model as M


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _attention(q, k, v):
    """Causal GQA attention, each chunk of query rows recomputed in the
    backward: (B, S, H, hd) from q and (B, S, K, hd) keys and values."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    chunk = max(1, 2**26 // (b * h * s))

    def rows(qc, c0):
        # query rows c0..c1-1 see keys 0..c1-1 at most: the later keys are
        # not scored at all
        c1 = c0 + qc.shape[2]
        scores = qc @ k[:, :, :c1].transpose(-1, -2) / math.sqrt(hd)
        r = torch.arange(c0, c1, device=q.device)
        mask = torch.arange(c1, device=q.device)[None, :] > r[:, None]
        return torch.softmax(scores.masked_fill(mask, float("-inf")), -1) @ v[:, :, :c1]

    out = [_ckpt(rows, q[:, :, c0:c0 + chunk], c0) for c0 in range(0, s, chunk)]
    return torch.cat(out, dim=2).transpose(1, 2)


def _layer(x, w, config):
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    heads, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or config["hidden_size"] // heads
    b, s, _ = x.shape
    h = M.rmsnorm(x, w["attn_norm"], eps)
    q = M.rope((h @ w["wq"]).view(b, s, heads, hd), theta)
    k = M.rope((h @ w["wk"]).view(b, s, kv, hd), theta)
    v = (h @ w["wv"]).view(b, s, kv, hd)
    x = x + _attention(q, k, v).reshape(b, s, heads * hd) @ w["wo"]
    h = M.rmsnorm(x, w["ffn_norm"], eps)
    if "router" in w["ffn"]:
        return x + M.moe_ffn(h, w["ffn"], config["num_experts_per_tok"], "f32")
    return x + M.dense_ffn(h, w["ffn"], "f32")


def loss(tree, config: dict, tokens, labels, ce_chunk: int = 2048):
    """Mean cross entropy of ``labels`` after ``tokens`` (both (B, S))."""
    x = tree["embed"][tokens.long()]
    for i in range(config["num_hidden_layers"]):
        x = _ckpt(lambda x, i=i: _layer(x, M._layer(tree, i), config), x)
    x = M.rmsnorm(x, tree["final_norm"]["scale"], config["rms_norm_eps"])
    emb = tree["embed"][:config["vocab_size"]]
    x, y = x.reshape(-1, x.shape[-1]), labels.reshape(-1).long()

    def part(xc, yc):
        return F.cross_entropy(xc @ emb.T, yc, reduction="sum")

    total = sum(_ckpt(part, x[c:c + ce_chunk], y[c:c + ce_chunk])
                for c in range(0, x.shape[0], ce_chunk))
    return total / y.numel()


def lr_at(step: int, opt: dict) -> float:
    """The learning rate of step ``step`` (from 1): linear warm-up, then a
    cosine decay to ``floor`` of it at ``total``."""
    lr, warm, total, floor = opt["lr"], opt["warmup"], opt["total"], opt["floor"]
    if step < warm:
        return lr * step / warm
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def train(tree, config: dict, batches, opt: dict) -> dict:
    """Steps of AdamW on ``tree`` (float32 leaves, updated in place) over
    ``batches`` [(tokens, labels)].  -> {"loss": [each step's], "grad_norm":
    [each step's global norm before clipping], "first_grad": {leaf: the
    norm of step 1's clipped gradient}}."""
    M.no_tf32()
    named = [(n, p.detach().requires_grad_()) for n, p in _leaves(tree)]
    rebuilt = _rebuild(tree, iter([p for _, p in named]))
    m = {n: torch.zeros_like(p) for n, p in named}
    v = {n: torch.zeros_like(p) for n, p in named}
    out = {"loss": [], "grad_norm": [], "first_grad": {}}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    for t, (tokens, labels) in enumerate(batches, start=1):
        lval = loss(rebuilt, config, tokens, labels)
        grads = torch.autograd.grad(lval, [p for _, p in named])
        with torch.no_grad():
            gn = math.sqrt(sum(sq_sum(g) for g in grads))
            clip = min(1.0, opt["grad_clip"] / max(gn, 1e-9))
            lr = lr_at(t, opt)
            for (n, p), g in zip(named, grads):
                if t == 1:
                    out["first_grad"][n] = clip * math.sqrt(sq_sum(g))
                # a leading row at a time: no full-size temporaries
                parts = zip(p, g, m[n], v[n]) if p.dim() > 1 else [(p, g, m[n], v[n])]
                for pr, gr, mr, vr in parts:
                    gr = gr * clip
                    mr.mul_(b1).add_(gr, alpha=1 - b1)
                    vr.mul_(b2).addcmul_(gr, gr, value=1 - b2)
                    step = (mr / (1 - b1 ** t)) / ((vr / (1 - b2 ** t)).sqrt() + eps)
                    pr.sub_(lr * (step + wd * pr))
        out["loss"].append(lval.item())
        out["grad_norm"].append(gn)
        del grads, lval
    return out


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def sq_sum(t, minus=None) -> float:
    """The sum of squares of ``t`` (less ``minus``), a leading row at a time
    in float32, summed in float64: no full-size temporary."""
    rows = zip(t, minus) if minus is not None else ((r, None) for r in t)
    if t.dim() < 2:
        rows = [(t, minus)]
    total = 0.0
    for a, b in rows:
        d = a.float() if b is None else a.float() - b.float()
        total += d.square().sum(dtype=torch.float64).item()
    return total


def change_norms(after, before) -> dict:
    """Each leaf's ||after - before||."""
    b = dict(_leaves(before))
    return {n: math.sqrt(sq_sum(t, b[n])) for n, t in _leaves(after)}
