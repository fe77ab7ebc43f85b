"""Weights the benchmark draws from the seed, on the device, in a few large
calls, at the shapes and dtypes of the program's parameter specs.

Every matrix is N(0, initializer_range) (the configuration's), drawn
directly in the dtype it is served or trained in; every norm scale (a spec
initialised to ones) is 1 + N(0, 0.1) in float32, so that a scale applied
wrongly shows.  All the leaves of one dtype are views of one buffer, filled
by one ``randn``: a handful of kernels in all, whatever the depth.  The
embedding's rows past the published vocabulary (the program pads the
table) are zero, as loading the published rows into it would leave them.
"""

from __future__ import annotations

import math

import torch


def _leaves(tree, path=()):
    """(path, spec) of every leaf, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw(specs, config: dict, seed: int, device, dtype: torch.dtype,
         keep_f32=frozenset()) -> dict:
    """The tree of ``specs`` (objects with ``shape`` and ``init``) filled
    from ``seed`` on ``device``: leaves named in ``keep_f32`` and norm
    scales in float32, the others in ``dtype``."""
    gen = torch.Generator(device).manual_seed(seed)
    std = config["initializer_range"]
    groups: dict[tuple[str, torch.dtype], list] = {}
    for path, spec in _leaves(specs):
        kind = "scale" if spec.init == "ones" else "zeros" if spec.init == "zeros" else "normal"
        dt = torch.float32 if kind == "scale" or path[-1] in keep_f32 else dtype
        groups.setdefault((kind, dt), []).append((path, spec))
    out: dict = {}
    for (kind, dt), items in sorted(groups.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        total = sum(math.prod(s.shape) for _, s in items)
        if kind == "zeros":
            buf = torch.zeros(total, dtype=dt, device=device)
        else:
            buf = torch.randn(total, generator=gen, dtype=dt, device=device)
            if kind == "scale":
                buf.mul_(0.1).add_(1.0)
            else:
                buf.mul_(std)
        off = 0
        for path, spec in items:
            n = math.prod(spec.shape)
            _put(out, path, buf[off:off + n].view(spec.shape))
            off += n
    out["embed"][config["vocab_size"]:] = 0
    return out
