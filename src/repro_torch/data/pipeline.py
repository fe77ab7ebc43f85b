"""Token data pipeline: synthetic and memmap sources, this process's slice of
the global batch, background prefetch (the port of
``repro/data/pipeline.py``, one process).

The sources are the reference's numpy code, so a batch is the same bits in
both packages and is reproducible across restarts from (seed, step) alone:
the checkpoint only needs the step counter.  :func:`batches` turns each
prefetched numpy batch into tensors on the given device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    source: str = "synthetic"       # synthetic | memmap:<path>
    prefetch: int = 2


class SyntheticLM:
    """Deterministic synthetic LM stream: zipf-ish token draws and shifted
    labels, drawn from ``np.random.default_rng((seed, step, offset))``."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, local_batch: int, offset: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, offset))
        # zipf-ish marginal over the vocab, cheap to sample
        z = rng.zipf(1.3, size=(local_batch, cfg.seq_len + 1))
        toks = np.minimum(z - 1, cfg.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class MemmapLM:
    """Flat uint16/uint32 token file; step/offset-addressed windows."""

    def __init__(self, cfg: DataConfig, path: str, dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=dtype, mode="r")

    def batch_at(self, step: int, local_batch: int, offset: int) -> dict:
        L = self.cfg.seq_len + 1
        n_windows = len(self.data) // L
        idx = (step * self.cfg.global_batch + offset + np.arange(local_batch)) % n_windows
        toks = np.stack([self.data[i * L:(i + 1) * L] for i in idx]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def make_source(cfg: DataConfig):
    if cfg.source == "synthetic":
        return SyntheticLM(cfg)
    if cfg.source.startswith("memmap:"):
        return MemmapLM(cfg, cfg.source.split(":", 1)[1])
    raise ValueError(cfg.source)


@dataclasses.dataclass
class HostShardSpec:
    """This process's slice of the global batch."""
    local_batch: int
    offset: int

    @classmethod
    def current(cls, global_batch: int) -> "HostShardSpec":
        """The port runs one process, which holds the whole batch."""
        return cls(local_batch=global_batch, offset=0)


def batches(cfg: DataConfig, device, start_step: int = 0) -> Iterator[dict]:
    """Prefetching batch iterator on ``device``, restartable at any step.
    A thread draws the next ``cfg.prefetch`` batches ahead; closing the
    iterator stops it."""
    src = make_source(cfg)
    spec = HostShardSpec.current(cfg.global_batch)
    q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put(src.batch_at(step, spec.local_batch, spec.offset), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield {k: torch.from_numpy(v).to(device) for k, v in q.get().items()}
    finally:
        stop.set()
