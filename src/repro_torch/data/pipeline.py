"""Token data pipeline: synthetic and memmap sources, this process's slice of
the global batch, background prefetch (the port of
``repro/data/pipeline.py``).

The sources are the reference's numpy code, so a batch is the same bits in
both packages and is reproducible across restarts from (seed, step) alone:
the checkpoint only needs the step counter.  As in the reference, each
process draws its slice of the global batch (:class:`HostShardSpec`, one
process a rank of ``torch.distributed``'s default group, or the whole batch
without one); on a mesh each rank draws the rows of its own block under the
batch's sharding, and :func:`batches` turns each prefetched numpy batch
into tensors on the given device (:func:`make_global_batch`).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist


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
    def current(cls, global_batch: int, sharding=None) -> "HostShardSpec":
        """Rank r of a process group of n draws rows ``[r B/n, (r+1) B/n)``;
        a process outside one draws the whole batch.  Under ``sharding`` (a
        :class:`~repro_torch.parallel.sharding.NamedSharding`, or a dict of
        them by key, all with the batch's spec) the rank draws the rows of
        its own block of the batch instead."""
        from ..parallel.sharding import NamedSharding, block

        if isinstance(sharding, dict):
            sharding = next(iter(sharding.values()))
        if isinstance(sharding, NamedSharding):
            rows = block(torch.arange(global_batch), sharding.spec[:1], sharding.mesh)
            return cls(local_batch=len(rows), offset=int(rows[0]))
        n, i = _world()
        if global_batch % n:
            raise ValueError(f"a global batch of {global_batch} does not split over {n} ranks")
        lb = global_batch // n
        return cls(local_batch=lb, offset=i * lb)


def _world() -> tuple[int, int]:
    """(world size, rank) of the default process group, or (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_global_batch(local: dict, sharding, device=None) -> dict:
    """This process's numpy rows -> tensors: on ``sharding`` where it is a
    device, else (the rows being the rank's block under ``sharding``,
    :meth:`HostShardSpec.current`) on ``device``.  The port of
    ``jax.make_array_from_process_local_data``: each rank holds its block
    and no collective runs."""
    from ..parallel.sharding import NamedSharding

    where = device if isinstance(sharding, (dict, NamedSharding)) else sharding
    return {k: torch.from_numpy(v).to(where) for k, v in local.items()}


def batches(cfg: DataConfig, sharding, start_step: int = 0, device=None) -> Iterator[dict]:
    """Prefetching batch iterator, restartable at any step: each batch is
    :func:`make_global_batch` of this process's rows under ``sharding`` (a
    device, or the batch's shardings on a mesh, with ``device`` where the
    rank's block goes).  A thread draws the next ``cfg.prefetch`` batches
    ahead; closing the iterator stops it."""
    src = make_source(cfg)
    spec = HostShardSpec.current(cfg.global_batch, sharding)
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
            yield make_global_batch(q.get(), sharding, device)
    finally:
        stop.set()
