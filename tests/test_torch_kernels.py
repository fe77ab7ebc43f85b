"""The port's kernel layer (repro_torch.kernels) against the JAX reference.

The same seeded numpy inputs go through the reference's plain versions
(``repro.kernels.ref``), its Pallas kernels in interpret mode, and the
port's plain versions / device dispatch on the CPU.  Tolerances are the
reference suite's (tests/test_kernels.py): matmul 2e-4 in f32 and 2e-2 in
bf16, matadd bit-exact.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``); here their wrappers are held to refusing what they
cannot take.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro.kernels.matadd import matadd as pl_matadd
from repro.kernels.matmul import matmul as pl_matmul
from repro_torch.core.executor import inputs_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.matadd import matadd as cuda_matadd
from repro_torch.kernels.matmul import choose_path, reset_launches, tma_strides
from repro_torch.kernels.matmul import matmul as cuda_matmul

CPU = torch.device("cpu")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


def _np(shape, dtype, seed):
    """Seeded numpy input; bf16 as ml_dtypes.bfloat16 (the same bits for both)."""
    if dtype == "int32":
        rng = np.random.default_rng(seed)
        return rng.integers(-(2**31), 2**31 - 1, size=shape, dtype=np.int64).astype(
            np.int32
        )
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _torch(x):
    return inputs_from_numpy({"x": x}, CPU)["x"]


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 128), (128, 256, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas_and_ref(shape, dtype):
    M, K, N = shape
    a, b = _np((M, K), dtype, 0), _np((K, N), dtype, 1)
    expect_ref = jref.matmul(jnp.asarray(a), jnp.asarray(b))
    expect_pl = pl_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    for got in (ref.matmul(_torch(a), _torch(b)), ops.matmul(_torch(a), _torch(b))):
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == (M, N)
        np.testing.assert_allclose(_f32(got), _f32(expect_ref), **_tol(dtype))
        np.testing.assert_allclose(_f32(got), _f32(expect_pl), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_transposed_operand(dtype):
    """The serving prefill passes ``x.T``: a strided view, no copy."""
    x = _np((96, 64), dtype, 2)
    xt = _torch(x)
    view = xt.T
    assert not view.is_contiguous()
    got = ops.matmul(xt, view)
    expect = jref.matmul(jnp.asarray(x), jnp.asarray(x).T)
    np.testing.assert_allclose(_f32(got), _f32(expect), **_tol(dtype))


@pytest.mark.parametrize("shape", [(100, 70, 50), (1, 33, 7), (17, 1, 5)])
def test_matmul_ragged(shape):
    M, K, N = shape
    a, b = _np((M, K), "float32", 3), _np((K, N), "float32", 4)
    got = ops.matmul(_torch(a), _torch(b))
    expect = jref.matmul(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(_f32(got), _f32(expect), **_tol("float32"))


@pytest.mark.parametrize("shape", [(256, 256), (512, 384), (64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_matadd_bit_exact_against_pallas(shape, dtype):
    if dtype == "int32":
        # the reference suite's case plus full-range values (wrap on overflow)
        a = np.arange(shape[0] * shape[1], dtype=np.int32).reshape(shape)
        cases = [(a, a[::-1].copy()), (_np(shape, dtype, 5), _np(shape, dtype, 6))]
    else:
        cases = [(_np(shape, dtype, 5), _np(shape, dtype, 6))]
    for a, b in cases:
        expect = np.asarray(pl_matadd(jnp.asarray(a), jnp.asarray(b), interpret=True))
        np.testing.assert_array_equal(expect, np.asarray(jref.matadd(a, b)))
        for got in (ref.matadd(_torch(a), _torch(b)), ops.matadd(_torch(a), _torch(b))):
            assert got.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(_bits(got), _bits(expect))


def _bits(x):
    """Raw bits, so bf16 compares exactly through numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_matadd_ragged_bit_exact(dtype):
    a, b = _np((33, 77), dtype, 7), _np((33, 77), dtype, 8)
    got = ops.matadd(_torch(a), _torch(b))
    np.testing.assert_array_equal(_bits(got), _bits(jref.matadd(jnp.asarray(a), jnp.asarray(b))))


def test_inputs_from_numpy_keeps_bits():
    for dtype in ("float32", "bfloat16", "int32"):
        x = _np((5, 3), dtype, 9)
        t = _torch(x)
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_bits(t), _bits(x))


def test_cpu_tensors_take_the_plain_version_not_the_kernel():
    mm0, ma0 = cuda_matmul.launches, cuda_matadd.launches
    x = _torch(_np((8, 8), "float32", 10))
    ops.matmul(x, x.T)
    ops.matadd(x, x)
    assert (cuda_matmul.launches, cuda_matadd.launches) == (mm0, ma0)


@pytest.mark.parametrize("kernel", [cuda_matmul, cuda_matadd])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """A wrapper launches on CUDA tensors or raises; it never computes on
    the CPU itself (and does not build anything before refusing)."""
    x = torch.ones(4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernel(x, x)


def test_matadd_prepare_copies_non_contiguous_operands():
    """K2 takes non-contiguous operands (a fused chain's reshapes and
    transposes): ``prepare`` reads contiguous ones in place and copies the
    others contiguous, and the plain sum of what it hands on is bit-equal."""
    from repro_torch.kernels.matadd import PATHS, prepare

    assert PATHS == ("direct", "copy")
    x = _torch(_np((6, 10), "float32", 11))
    y = _torch(_np((10, 6), "float32", 12))
    path, a, b = prepare(x, y.T.contiguous())
    assert path == "direct" and a is x
    for a0, b0 in ((x, y.T), (x[:, ::2].T, y[::2]), (y.T, y.T)):
        path, a, b = prepare(a0, b0)
        assert path == "copy" and a.is_contiguous() and b.is_contiguous()
        assert torch.equal(ref.matadd(a, b), a0 + b0)


def test_warm_up_is_a_no_op_on_the_cpu():
    mm0, ma0 = cuda_matmul.launches, cuda_matadd.launches
    ops.warm_up("cpu")
    assert (cuda_matmul.launches, cuda_matadd.launches) == (mm0, ma0)


def test_ctypes_signatures_match_the_cuda_sources():
    """Every C entry point the wrappers call exists in a source, with as many
    parameters as its ctypes argtypes (a mismatch would pass garbage)."""
    import re

    from repro_torch.kernels import _build

    found = {}
    for src in _build.sources():
        for name, params in re.findall(
            r'extern "C" int (\w+)\(([^)]*)\)', src.read_text(), flags=re.S
        ):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert {s.name for s in _build.sources()} == {
        "matmul.cu", "matadd.cu", "flash_attention.cu", "flash_attention_bwd.cu", "wkv6.cu",
        "wkv6_bwd.cu"}
    assert {n: len(a) for n, a in _build.SIGNATURES.items()} == found


def test_cached_library_keeps_its_build_log(tmp_path, monkeypatch):
    """A second run loads the cached library without ``nvcc``; the
    ``ptxas`` report that ``chip_smoke.py`` checks is read back from the log
    the build left beside it."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "last_log", "")
    (tmp_path / "k.cu").write_text("// kernel\n")
    lib = tmp_path / "build" / f"libreprokernels-{_build._digest(_build.sources())}.so"
    lib.parent.mkdir()
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("== k.cu\nptxas info    : Used 32 registers\n")
    assert _build.build() == lib
    assert "Used 32 registers" in _build.last_log


def test_build_digest_covers_the_included_headers(tmp_path, monkeypatch):
    """An edited ``*.cuh`` must rebuild the library: the headers are not
    compiled on their own, so only the digest sees them."""
    from repro_torch.kernels import _build

    assert [p.name for p in _build.headers()] == ["attention_tf32.cuh", "hopper.cuh"]
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text('#include "k.cuh"\n')
    head = tmp_path / "k.cuh"
    head.write_text("// v1\n")
    before = _build._digest(_build.sources())
    assert _build._digest(_build.sources()) == before
    head.write_text("// v2\n")
    assert _build._digest(_build.sources()) != before


# The matmul kernel's path is a pure function of the dtype, the strides and
# the pointers' alignment: `wgmma` where TMA can address both operands.
_S = 2048
_ALIGNED = 1 << 20  # a 16-byte-aligned address
_PATH_CASES = {  # dtype, M, K, N, A strides, B strides, A pointer, B pointer -> path
    "prefill x @ x.T": ((torch.float32, _S, _S, _S, (_S, 1), (1, _S), _ALIGNED, _ALIGNED),
                        "wgmma"),
    "MM DAG, row-major B": ((torch.float32, _S, _S, _S, (_S, 1), (_S, 1), _ALIGNED, _ALIGNED),
                            "wgmma"),
    "K = 1000, 16-byte rows": ((torch.float32, _S, 1000, _S, (1000, 1), (_S, 1), _ALIGNED,
                                _ALIGNED), "wgmma"),
    "K = 1999 f32": ((torch.float32, 2047, 1999, 1000, (1999, 1), (1000, 1), _ALIGNED,
                      _ALIGNED), "fma"),
    "bf16 row-major": ((torch.bfloat16, 1024, 1024, 1024, (1024, 1), (1024, 1), _ALIGNED,
                        _ALIGNED), "wgmma"),
    "bf16 transposed A": ((torch.bfloat16, 512, 512, 512, (1, 512), (1, 512), _ALIGNED,
                           _ALIGNED), "wgmma"),
    "bf16 row of 1004 (not 8-aligned)": ((torch.bfloat16, 64, 1004, 64, (1004, 1), (64, 1),
                                          _ALIGNED, _ALIGNED), "fma"),
    "base 4 bytes off": ((torch.float32, _S, _S, _S, (_S, 1), (1, _S), _ALIGNED + 4, _ALIGNED),
                         "fma"),
    "no unit stride": ((torch.float32, 64, 64, 64, (128, 2), (64, 1), _ALIGNED, _ALIGNED),
                       "fma"),
    "K = 0": ((torch.float32, 64, 0, 64, (0, 1), (64, 1), _ALIGNED, _ALIGNED), "fma"),
}


@pytest.mark.parametrize("case", sorted(_PATH_CASES))
def test_matmul_path_is_chosen_by_layout(case):
    args, want = _PATH_CASES[case]
    path, strides = choose_path(*args)
    assert path == want
    if path == "wgmma":  # each operand handed over with exactly one unit stride
        sam, sak, sbk, sbn = strides
        assert (sam == 1) != (sak == 1) and (sbk == 1) != (sbn == 1)
    else:
        assert strides == (*args[4], *args[5])


@pytest.mark.parametrize("rows, k, s_rows, s_k, want", [
    (2048, 2048, 2048, 1, (2048, 1)),  # K-major
    (2048, 2048, 1, 2048, (1, 2048)),  # MN-major
    (1, 7, 123, 1, (8, 1)),            # one row: its stride is never used
    (5, 1, 1, 99, (1, 8)),             # one k: the same
    (4, 4, 0, 1, None),                # a broadcast row
    (4, 8, 4, 1, None),                # rows that overlap
])
def test_tma_strides(rows, k, s_rows, s_k, want):
    assert tma_strides(rows, k, s_rows, s_k, 4) == want


def test_reset_launches_clears_every_path():
    cuda_matmul.launches, cuda_matmul.launches_by_path = 3, {"wgmma": 2, "fma": 1}
    reset_launches()
    assert cuda_matmul.launches == 0
    assert cuda_matmul.launches_by_path == {"wgmma": 0, "fma": 0}


@pytest.mark.parametrize("name", ["matmul", "matadd", "flash_attention", "wkv6",
                                  "flash_attention_bwd", "wkv6_bwd"])
def test_every_kernel_module_resets_its_counts(name):
    """Each kernel module's reset_launches sets its wrapper's launch count,
    each path's where it has paths (one per name in PATHS), and the capped
    launches' where it counts them (K3 and K3b), to 0."""
    import importlib

    module = importlib.import_module(f"repro_torch.kernels.{name}")
    kernel = getattr(module, name)
    kernel.launches = 3
    if hasattr(kernel, "launches_by_path"):
        kernel.launches_by_path = dict.fromkeys(module.PATHS, 1)
    assert hasattr(kernel, "launches_capped") == name.startswith("flash_attention")
    if hasattr(kernel, "launches_capped"):
        kernel.launches_capped = 2
    module.reset_launches()
    assert kernel.launches == 0
    if hasattr(kernel, "launches_by_path"):
        assert kernel.launches_by_path == dict.fromkeys(module.PATHS, 0)
    if hasattr(kernel, "launches_capped"):
        assert kernel.launches_capped == 0


def _tf32(x):
    """The top 19 bits of each f32 (sign, exponent, 10 mantissa bits): what
    the tensor cores read of an f32 operand."""
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("passes", [3, 1])
def test_3xtf32_meets_the_f32_tolerance_and_1xtf32_does_not(passes):
    """The precision scheme of the matmul kernel's f32 path, emulated in
    plain float32 at 512^3: x = hi + lo with hi = tf32(x) and lo = tf32(x -
    hi), and hi.hi + hi.lo + lo.hi summed in f32 (a product of two TF32
    values is exact in f32).  Held to the reference at the f32 tolerance
    the card check uses (chip_smoke.mm_tol: 2e-4 x K / 128); one pass,
    hi.hi alone, is not within it."""
    a, b = _np((512, 512), "float32", 11), _np((512, 512), "float32", 12)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    t = {n: torch.from_numpy(v) for n, v in
         dict(a_hi=a_hi, a_lo=a_lo, b_hi=b_hi, b_lo=b_lo).items()}
    got = t["a_hi"] @ t["b_hi"]
    if passes == 3:
        got = got + (t["a_hi"] @ t["b_lo"] + t["a_lo"] @ t["b_hi"])
    expect = _f32(jref.matmul(jnp.asarray(a), jnp.asarray(b)))
    tol = 2e-4 * 512 / 128
    close = np.isclose(got.numpy(), expect, rtol=tol, atol=tol)
    assert close.all() if passes == 3 else not close.all()
