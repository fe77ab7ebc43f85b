"""The port's RWKV-6 recurrence (K4's plain version, the device dispatch,
and the model's ``rwkv6_block``) against the JAX reference.

The same seeded numpy inputs go through the reference's definition
(``repro.kernels.ref.wkv6``, which also returns the final state), its Pallas
kernel in interpret mode (as ``tests/test_kernels.py`` runs it) and the
port, at the reference suite's 1e-5.  The CUDA kernel itself runs only on
the card (``chip_smoke.py``); here its wrapper is held to refusing CPU
tensors.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as pl_wkv6
from repro.models import rwkv as jrwkv
from repro.models.layers import Ctx as JCtx
from repro.models.params import init_params as jinit_params
from repro.parallel.sharding import TRAIN_RULES
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.wkv6 import wkv6 as cuda_wkv6
from repro_torch.models import rwkv as trwkv
from repro_torch.models.layers import Ctx
from repro_torch.models.params import params_from_numpy

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, H, S, N, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, N)).astype(np.float32) for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, H, S, N))))).astype(np.float32)
    u = np.full((H, N), 0.1, np.float32)
    return r, k, v, w, u


def _t(x):
    return params_from_numpy(x, CPU)


@pytest.mark.parametrize("S", [16, 33])
@pytest.mark.parametrize("N", [8, 16])
def test_wkv6_matches_ref_and_pallas(S, N):
    r, k, v, w, u = _inputs(2, 3, S, N, seed=S * 100 + N)
    jargs = tuple(map(jnp.asarray, (r, k, v, w, u)))
    expect_o, expect_state = jref.wkv6(*jargs)
    expect_pl = pl_wkv6(*jargs, interpret=True)
    for fn in (ref.wkv6, ops.wkv6):
        o, state = fn(*map(_t, (r, k, v, w, u)))
        assert tuple(o.shape) == r.shape and tuple(state.shape) == (2, 3, N, N)
        np.testing.assert_allclose(o.numpy(), np.asarray(expect_o), **TOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(expect_pl), **TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(expect_state), **TOL)


def test_wkv6_takes_the_models_strided_views():
    """The model hands (B, S, H, N) tensors over as (B, H, S, N) views."""
    r, k, v, w, u = _inputs(2, 3, 9, 8, seed=5)
    views = [_t(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).transpose(1, 2)
             for x in (r, k, v, w)]
    assert not views[0].is_contiguous()
    o, state = ops.wkv6(*views, _t(u))
    expect_o, expect_state = jref.wkv6(*map(jnp.asarray, (r, k, v, w, u)))
    np.testing.assert_allclose(o.numpy(), np.asarray(expect_o), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(expect_state), **TOL)


def test_rwkv6_block_matches_reference_on_a_ragged_length():
    """S = 33: the reference pads its chunked scan to 64 with decay 1; one
    K4 call needs no padding.  Output and both cache entries agree."""
    cfg = dataclasses.replace(jget_config("rwkv6_3b").smoke(), activation_dtype="float32")
    specs = jrwkv.rwkv_params(cfg)
    jp = jinit_params(specs, jax.random.PRNGKey(0))
    # the zero-init anchors and bonus would leave the token shift and u idle
    rng = np.random.default_rng(7)
    jp = dict(jp, **{name: jnp.asarray(rng.standard_normal(jp[name].shape) * 0.3,
                                       jnp.float32)
                     for name in ("mu_x", "mu", "w0", "u")})
    x = (rng.standard_normal((2, 33, cfg.d_model)) * 0.5).astype(np.float32)
    out, cache = jrwkv.rwkv6_block(jp, jnp.asarray(x), cfg, JCtx(rules=TRAIN_RULES,
                                                                 dtype=jnp.float32))
    tcfg = dataclasses.replace(get_config("rwkv6_3b").smoke(), activation_dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    got, tcache = trwkv.rwkv6_block(tp, _t(x), tcfg, Ctx(dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache["S"].numpy(), np.asarray(cache["S"]), **TOL)
    np.testing.assert_array_equal(tcache["x_last"].numpy(), np.asarray(cache["x_last"]))


def test_cpu_tensors_take_the_plain_wkv6():
    n0 = cuda_wkv6.launches
    x = torch.ones(1, 1, 4, 16)
    ops.wkv6(x, x, x, x, x[0, 0, :1])
    assert cuda_wkv6.launches == n0


def test_wkv6_kernel_wrapper_refuses_cpu_tensors():
    x = torch.ones(1, 1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wkv6(x, x, x, x, x[0, 0, :1])
