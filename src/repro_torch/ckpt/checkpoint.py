"""Checkpointing with asynchronous writes, step management and restart (the
port of ``repro/ckpt/checkpoint.py``).

Layout (one directory per step), the reference's:
    <dir>/step_00000100/
        MANIFEST.json            # leaves' shapes and dtypes, the step, the ranks
        shard_0.npz              # process 0's leaves, "/"-joined paths
        shard_1.npz ...          # on a mesh, each rank's blocks
    <dir>/LATEST                 # atomically updated pointer

* writes go to a temp directory + an atomic rename, so a failure mid-write
  never corrupts the previous checkpoint (restart reads LATEST): every rank
  writes its blocks into the step's temp directory and rank 0, once every
  rank's file is there, writes the manifest and renames it (one process is
  the one-rank case);
* ``save`` copies every leaf to the host before it returns, then writes on
  a background thread while the next steps run (the trainer updates its
  tensors in place, so the copy cannot wait for the thread);
* the newest ``keep`` checkpoints are kept;
* ``restore`` puts the leaves on a device: on the mesh that wrote them each
  rank reads its own blocks; a one-process checkpoint restores on a mesh
  by cutting each leaf into the rank's block under ``shardings``.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits with the
dtype "bfloat16" in the manifest, and read back by that name.  A
checkpoint the reference wrote (its leaves f32, int32 or bf16) restores.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist


# how long rank 0 waits for the other ranks' files of a step
RANKS_TIMEOUT_S = 600


def _rank_world() -> tuple[int, int]:
    """(this process's rank, the world size) of the default process group,
    or (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(a host copy of ``t`` numpy can hold, the dtype's name)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self.rank, self.world = _rank_world()
        self._error: BaseException | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: dict, *, blocking: bool = False):
        """state: a nested dict of tensors, copied to the host before this
        returns.  Every rank calls it at the same steps; with ``blocking``
        it returns on every rank once the step is on disk."""
        self.wait()              # one in-flight save at a time
        tmp = os.path.join(self.dir, f".tmp_step_{step:08d}")
        if self.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)   # a failed earlier try's files
        _barrier()               # rank 0's earlier saves are on disk, the temp dir clear
        if self.latest_step() == step:
            return               # already on disk (loop-end double save)
        host, dtypes = {}, {}
        for k, v in _flatten(state).items():
            host[k], dtypes[k] = _to_host(v)
        if blocking:
            self._write(step, tmp, host, dtypes)
            _barrier()
        else:
            self._thread = threading.Thread(target=self._write_async,
                                            args=(step, tmp, host, dtypes), daemon=True)
            self._thread.start()

    def _write_async(self, *args):
        try:
            self._write(*args)
        except BaseException as e:   # re-raised by wait()
            self._error = e

    def _write(self, step: int, tmp: str, host: dict, dtypes: dict):
        """Every rank writes its file into the step's temp directory (a part
        file renamed once whole); rank 0, once every rank's file is there,
        writes the manifest, moves the directory in place and points LATEST
        at it."""
        os.makedirs(tmp, exist_ok=True)
        shard = os.path.join(tmp, f"shard_{self.rank}.npz")
        with open(shard + ".part", "wb") as f:
            np.savez(f, **host)
        os.replace(shard + ".part", shard)
        if self.rank != 0:
            return
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        missing = list(range(self.world))
        while missing := [r for r in missing
                          if not os.path.exists(os.path.join(tmp, f"shard_{r}.npz"))]:
            if time.monotonic() > deadline:
                raise TimeoutError(f"step {step}: ranks {missing} wrote no checkpoint file in "
                                   f"{RANKS_TIMEOUT_S} s; LATEST keeps the previous step")
            time.sleep(0.01)
        manifest = {
            "step": step,
            "world": self.world,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]} for k, v in host.items()},
            "time": time.time(),
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        name = f"step_{step:08d}"
        final, old = os.path.join(self.dir, name), os.path.join(self.dir, f".old_{name}")
        if os.path.exists(final):   # a step LATEST does not point at: set aside, not deleted
            shutil.rmtree(old, ignore_errors=True)
            os.rename(final, old)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, ".LATEST_tmp"), "w") as f:
            f.write(name)
        os.replace(os.path.join(self.dir, ".LATEST_tmp"), os.path.join(self.dir, "LATEST"))
        shutil.rmtree(old, ignore_errors=True)
        self._gc()

    def wait(self):
        """Join the in-flight save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def latest_step(self) -> int | None:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            name = f.read().strip()
        with open(os.path.join(self.dir, name, "MANIFEST.json")) as f:
            return json.load(f)["step"]

    def restore(self, step: int | None = None, device="cpu", shardings=None):
        """Returns (step, state with its tensors on ``device``), or (None,
        None) when no checkpoint exists.  A checkpoint of this many ranks
        gives each its own blocks; a one-process checkpoint restored on a
        mesh gives each rank its block of every leaf under ``shardings`` (a
        tree of :class:`~repro_torch.parallel.sharding.NamedSharding` of the
        state's structure)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None, None
        name = f"step_{step:08d}"
        with open(os.path.join(self.dir, name, "MANIFEST.json")) as f:
            manifest = json.load(f)
        leaves, written = manifest["leaves"], manifest.get("world", 1)
        if written not in (1, self.world):
            raise ValueError(f"{name} was written by {written} ranks; this run has {self.world}")
        cut = written == 1 and self.world > 1
        if cut and shardings is None:
            raise ValueError(f"{name} holds whole tensors: restoring on {self.world} ranks needs "
                             f"the shardings")
        rank = self.rank if written > 1 else 0
        with np.load(os.path.join(self.dir, name, f"shard_{rank}.npz")) as z:
            flat = {k: _to_tensor(z[k], leaves[k]["dtype"], "cpu") for k in z.files}
        if cut:
            from ..parallel.sharding import block

            sh = _flatten(shardings)
            flat = {k: block(v, sh[k].spec, sh[k].mesh).clone() for k, v in flat.items()}
        return step, _unflatten({k: v.to(device) for k, v in flat.items()})
