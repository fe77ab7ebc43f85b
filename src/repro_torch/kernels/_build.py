"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Every ``*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``) into
an object of its own, all at once in parallel, and the objects are linked
into one shared library with a plain C interface that :mod:`ctypes` loads.
The library's name carries a hash of the sources, the headers they include
(``*.cuh``, not compiled on their own) and the flags, so an edited source or
header rebuilds and an unchanged tree loads the cached library.  The build
runs at the first kernel launch, never at import, into ``csrc/build/``
(listed in ``.gitignore``); ``nvcc``'s output is kept beside the library
(``.log``), so a run that loads the cached library still has it.

Nothing here imports PyTorch's C++ headers: that keeps one build to a few
seconds of ``nvcc`` instead of minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# argtypes of each C entry point: every pointer and the stream as c_void_p
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)
SIGNATURES = {
    # dtype, path, a, b, c, M, N, K, sam, sak, sbk, sbn, stream
    "repro_matmul": (_I, _I, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _P),
    # dtype -> bytes of dynamic shared memory of the wgmma kernel
    "repro_matmul_smem": (_I,),
    # dtype, a, b, c, n, stream
    "repro_matadd": (_I, _P, _P, _P, _L, _P),
    # dtype, q, k, v, o, lse (or NULL), B, H, G, Sq, Sk, hd, kv_len, causal, scale,
    # cap (<= 0: none), strides[16], stream
    "repro_flash_attention": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                              _F, _LP, _P),
    # dtype, hd -> bytes of dynamic shared memory of that kernel
    "repro_flash_attention_smem": (_I, _I),
    # q, k, v, o, lse (or NULL), part, B, H, G, Sq, Sk, hd, kv_len, causal, scale, cap,
    # n_split, chunk, strides[16], stream
    "repro_flash_attention_split": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _F, _F, _I, _I, _LP, _P),
    # hd -> bytes of shared memory a block of the split kernel takes at most
    "repro_flash_attention_split_smem": (_I,),
    # dtype, q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, G, Sq, Sk, hd, kv_len, causal,
    # scale, cap (<= 0: none), strides[32], stream
    "repro_flash_attention_bwd": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _F, _F, _LP, _P),
    # dtype, 0 = the dq kernel or 1 = the dk/dv kernel, hd -> bytes of dynamic shared memory
    "repro_flash_attention_bwd_smem": (_I, _I, _I),
    # r, k, v, w, u, o, state, B, H, S, N, strides[8], stream
    "repro_wkv6": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LP, _P),
    # r, k, v, w, u, dout, dstate (or NULL), ckpt, dr, dk, dv, dw, du_part, du, B, H, S, N,
    # strides[24], stream
    "repro_wkv6_bwd": (*(_P,) * 14, _I, _I, _I, _I, _LP, _P),
    # N, 0 = the checkpoint pass or 1 = the main pass, out[3] -> dynamic shared memory,
    # threads a block, resident blocks an SM
    "repro_wkv6_bwd_info": (_I, _I, ctypes.POINTER(_I)),
}

_lib: ctypes.CDLL | None = None
last_log = ""  # nvcc's output (ptxas register/shared-memory report) of the build


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for path in cand:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [*srcs, *headers()]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (one ``nvcc`` each, started together), link one
    ``.so``, and return its path; a cached library with the same hash is
    reused, and :data:`last_log` read back from beside it.  Raises with
    ``nvcc``'s output when a step fails."""
    global last_log
    srcs = sources()
    lib = BUILD_DIR / f"libreprokernels-{_digest(srcs)}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        last_log = log.read_text() if log.exists() else ""
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for s, o in zip(srcs, objs)
        ]
        logs = []
        failed = []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                failed.append(s.name)
        last_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{last_log}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking {lib.name} failed:\n{link.stdout}")
        tmp_log = Path(tmp) / log.name
        tmp_log.write_text(last_log)
        os.replace(tmp_log, log)  # before the library: a cached library has its log
        os.replace(tmp_lib, lib)  # atomic: concurrent builders never see half a file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
