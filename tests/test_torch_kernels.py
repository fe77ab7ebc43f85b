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
        "matmul.cu", "matadd.cu", "flash_attention.cu", "wkv6.cu"}
    assert {n: len(a) for n, a in _build.SIGNATURES.items()} == found


def test_build_digest_covers_the_included_headers(tmp_path, monkeypatch):
    """An edited ``*.cuh`` must rebuild the library: the headers are not
    compiled on their own, so only the digest sees them."""
    from repro_torch.kernels import _build

    assert [p.name for p in _build.headers()] == ["hopper.cuh"]
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text('#include "k.cuh"\n')
    head = tmp_path / "k.cuh"
    head.write_text("// v1\n")
    before = _build._digest(_build.sources())
    assert _build._digest(_build.sources()) == before
    head.write_text("// v2\n")
    assert _build._digest(_build.sources()) != before
