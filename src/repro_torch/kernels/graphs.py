"""A fused group-step captured as one CUDA graph.

The reference compiles each super-step chain once with ``jax.jit(chain,
donate_argnums=...).lower(...).compile()`` and calls the executable on every
cache hit.  The port captures the chain (:func:`repro_torch.kernels.ops.
build_chain`'s callable) into one ``torch.cuda.CUDAGraph`` over static input
buffers and replays it.  What that takes, beside the capture itself:

* **Static inputs.**  A graph reads fixed addresses, so each replay first
  copies the chain's external inputs into the entry's static buffers (one
  device copy per input; the executor counts them and their bytes).
  Host-built TMA descriptors (K1, K3, K4) are baked into the graph by
  value: they stay right only because those addresses never change.
* **Fresh outputs.**  A replay overwrites the graph's static outputs, so a
  block an earlier replay handed out would silently change under the
  executor's no-in-place-write rule.  Every replay returns clones of the
  kept outputs instead.
* **Launch counts.**  The kernel wrappers count a launch when they are
  called, which during a capture launches nothing.  The capture's counts
  are taken back off the wrappers and kept; each replay adds them, kernel
  by kernel and path by path.
* **Capture-safe calls only.**  ``ops.ensure_warm`` builds the library,
  sets each kernel's shared-memory attribute and warms every path before
  the first capture on a device, so no ``nvcc`` build or
  ``cudaFuncSetAttribute`` runs inside one.
* **Memory.**  Each graph keeps a private memory pool (the chain's live
  set); :meth:`CapturedChain.release` frees it, and the executor's
  ``SuperStepCache`` calls it when an entry is evicted or the cache cleared.
* **Warm-up.**  A chain of library calls (cuBLAS products, as in a served
  model's decode step) runs ``warmup`` times on the capture's stream first,
  on the real inputs, so what those libraries set up lazily is not
  captured.  A warm-up executes the chain: a caller whose chain writes
  state in place restores that state afterwards.

There is no uncaptured fallback: a capture or a replay that fails raises.
"""

from __future__ import annotations

import torch

from . import ops


def _counts_since(before: dict) -> dict:
    """The launch counts added since ``before`` (``ops.launch_counts()``)."""
    now = ops.launch_counts()
    return {k: {p: n - before[k][p] for p, n in by.items() if n != before[k][p]}
            for k, by in now.items()}


class CapturedChain:
    """``chain(*ext) -> tuple of tensors`` captured once on ``device`` over
    static buffers shaped, typed and strided like ``ext_args`` (and holding
    their values when ``warmup`` > 0)."""

    def __init__(self, chain, ext_args, device: torch.device, *, warmup: int = 0):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        ops.ensure_warm(device)
        self.device = device
        # same shape, dtype and (dense) strides as the first externals seen
        self.static_in = [torch.empty_like(a, device=device) for a in ext_args]
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)  # capture needs a non-default stream
        if warmup:
            for dst, src in zip(self.static_in, ext_args):
                dst.copy_(src)
            side.wait_stream(cur)
            with torch.cuda.device(device), torch.cuda.stream(side):
                for _ in range(warmup):
                    chain(*self.static_in)
        self.graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        torch.cuda.synchronize(device)  # nothing in flight while capturing
        try:
            with torch.cuda.device(device), torch.cuda.stream(side):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outs = chain(*self.static_in)
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was already invalidated
                    raise
                self.graph.capture_end()
        finally:
            # capture launched nothing on the card: take its counts back
            self.launches = _counts_since(before)
            ops.add_launches(self.launches, sign=-1)
        cur.wait_stream(side)
        if not all(isinstance(o, torch.Tensor) for o in outs):
            raise TypeError("a captured chain must return tensors")
        self.static_out = tuple(outs)

    def replay(self, ext_args=None, *, clone: bool = True) -> tuple:
        """Copy ``ext_args`` into the static inputs (``None``: the caller has
        written them in place), replay the graph on the current stream and
        return fresh clones of its outputs, or with ``clone=False`` the
        static outputs themselves, which the next replay overwrites."""
        if self.graph is None:
            raise RuntimeError("replay of a released CUDA graph")
        for dst, src in zip(self.static_in, ext_args or ()):
            dst.copy_(src)
        self.graph.replay()
        ops.add_launches(self.launches)
        if not clone:
            return self.static_out
        return tuple(o.clone() for o in self.static_out)

    def release(self) -> None:
        """Free the graph and its private memory pool (after the device has
        finished every replay that reads it)."""
        if self.graph is None:
            return
        torch.cuda.synchronize(self.device)
        self.graph.reset()
        self.graph = None
        self.static_in, self.static_out = [], ()


class EagerChain:
    """A chain on a CPU group, where CUDA graphs do not exist: called as it
    is on every replay, cached and counted like a :class:`CapturedChain`."""

    def __init__(self, chain):
        self.chain = chain

    def replay(self, ext_args) -> tuple:
        return self.chain(*ext_args)

    def release(self) -> None:
        pass
