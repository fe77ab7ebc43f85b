"""Checkpointing with asynchronous writes, step management and restart (the
port of ``repro/ckpt/checkpoint.py``, one process).

Layout (one directory per step), the reference's:
    <dir>/step_00000100/
        MANIFEST.json            # leaves' shapes and dtypes, the step
        shard_0.npz              # this process's leaves, "/"-joined paths
    <dir>/LATEST                 # atomically updated pointer

* writes go to a temp directory + an atomic rename, so a failure mid-write
  never corrupts the previous checkpoint (restart reads LATEST);
* ``save`` copies every leaf to the host before it returns, then writes on
  a background thread while the next steps run (the trainer updates its
  tensors in place, so the copy cannot wait for the thread);
* the newest ``keep`` checkpoints are kept;
* ``restore`` puts the leaves on a device.

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

PROCESS_INDEX = 0  # the port runs one process


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

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: dict, *, blocking: bool = False):
        """state: a nested dict of tensors, copied to the host before this
        returns."""
        self.wait()              # one in-flight save at a time
        if self.latest_step() == step:
            return               # already on disk (loop-end double save)
        host, dtypes = {}, {}
        for k, v in _flatten(state).items():
            host[k], dtypes[k] = _to_host(v)
        if blocking:
            self._write(step, host, dtypes)
        else:
            self._thread = threading.Thread(target=self._write, args=(step, host, dtypes),
                                            daemon=True)
            self._thread.start()

    def _write(self, step: int, host: dict, dtypes: dict):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, f".tmp_{name}_{os.getpid()}_{time.time_ns()}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{PROCESS_INDEX}.npz"), **host)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]} for k, v in host.items()},
            "time": time.time(),
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.dir, name)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, ".LATEST_tmp"), "w") as f:
            f.write(name)
        os.replace(os.path.join(self.dir, ".LATEST_tmp"), os.path.join(self.dir, "LATEST"))
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, step: int | None = None, device="cpu"):
        """Returns (step, state with its tensors on ``device``), or (None,
        None) when no checkpoint exists."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None, None
        name = f"step_{step:08d}"
        with open(os.path.join(self.dir, name, "MANIFEST.json")) as f:
            leaves = json.load(f)["leaves"]
        with np.load(os.path.join(self.dir, name, f"shard_{PROCESS_INDEX}.npz")) as z:
            flat = {k: _to_tensor(z[k], leaves[k]["dtype"], device) for k in z.files}
        return step, _unflatten(flat)
