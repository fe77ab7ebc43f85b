"""Faults planted in the program for one run, to see the output check
come out not correct: the tests of ``test_bench_faults.py`` drive a whole
run with each, and ``calibrate.py`` reads each at the cell's own size on
the card (a training fault's reading sets an upper end of a limit).

Each is a context manager that swaps one function of the program for a
broken one and puts the original back."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _swapped(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def token_altered(every: int = 5):
    """Serving: the logits of the decode steps at positions divisible by
    ``every`` shifted by one id, so every request's token of that step is
    its best one's neighbour.  The choice is made on the device from the
    step's position, so a CUDA graph captured once alters the same steps as
    eager decoding."""
    import torch

    from repro_torch.models import transformer as T

    def make(orig):
        def decode_step(params, cache, tok, pos, *args, **kwargs):
            logits, cache = orig(params, cache, tok, pos, *args, **kwargs)
            hit = torch.as_tensor(pos, device=logits.device) % every == 0
            return torch.where(hit, logits.roll(1, -1), logits), cache
        return decode_step
    return _swapped(T, "decode_step", make)


def cache_unwritten():
    """Serving: a decode step that leaves its state unchanged (the new key
    and value never reach the cache)."""
    from repro_torch.models import layers as L

    def make(orig):
        def decode_attn_dense(q, ck, cv, *args, **kwargs):
            o, _ = orig(q, ck.clone(), cv.clone(), *args, **kwargs)
            return o, (ck, cv)
        return decode_attn_dense
    return _swapped(L, "decode_attn_dense", make)


def update_skipped():
    """Training: a step that returns its state unchanged (AdamW's update
    not applied; the gradient norm still reported)."""
    from repro_torch.optim import adamw

    def make(orig):
        def apply_updates(params, grads, state, cfg, lr_scale=1.0, specs=None, mesh=None):
            return params, state, {"grad_norm": adamw.global_norm(grads, specs, mesh)}
        return apply_updates
    return _swapped(adamw, "apply_updates", make)


def half_batch():
    """Training: half of the batch left out, the mean taken over the rest."""
    from repro_torch.models import transformer as T

    def make(orig):
        def lm_loss(params, batch, cfg, ctx):
            half = batch["tokens"].shape[0] // 2
            return orig(params, {k: v[:half] for k, v in batch.items()}, cfg, ctx)
        return lm_loss
    return _swapped(T, "lm_loss", make)


SERVING = {"token_altered": token_altered, "cache_unwritten": cache_unwritten}
TRAINING = {"update_skipped": update_skipped, "half_batch": half_batch}
