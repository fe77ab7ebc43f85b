"""The port's Mamba mixer (``repro_torch/models/ssm.py``) against the JAX
reference's (``repro/models/ssm.py``) on jamba's reduced config (d 128,
d_inner 256, d_state 16, d_conv 4), f32 activations.

Every parameter is drawn from a numpy seed (``A_log`` as the log of 1..16,
``dt_bias`` and ``D`` spread around their inits, so the decay, the skip and
the softplus all see more than their initial constants) and carried across
with ``params_from_numpy``; inputs come from the same seed.  Tolerance: rtol
and atol 1e-4 (f32, products summed in another order).

* ``mamba_block``: the output and the decode-ready state (``h`` and the
  conv cache) at S = 12 (not a multiple of the reference's 16-step chunk),
  32 and 2 (shorter than ``d_conv - 1``, so the conv cache is zero-padded);
* ``mamba_decode_block`` over 4 chained steps from the reference's state;
* a prefill of S then k decode steps against the full forward over S + k;
* the chunk checkpoint under ``ctx.remat``: the gradients bit-equal to those
  without, and equal to ``jax.grad`` of the reference at 1e-4;
* ``cast_params`` keeps ``A_log``, ``D`` and ``dt_bias`` in f32.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jreg
from repro.launch.steps import DistConfig, make_ctx
from repro.models import ssm as jssm
from repro_torch.configs import registry as treg
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import cast_params, params_from_numpy, tree_leaves

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "jamba_1_5_large_398b"
B = 2


def _cfgs():
    jcfg = dataclasses.replace(jreg.get_config(ARCH).smoke(), activation_dtype="float32")
    tcfg = dataclasses.replace(treg.get_config(ARCH).smoke(), activation_dtype="float32")
    return jcfg, tcfg


def _np_params(tcfg, seed=0):
    """Every leaf of the mixer's spec tree drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(name, spec):
        if name == "A_log":
            return np.log(rng.uniform(1.0, 16.0, spec.shape)).astype(np.float32)
        if name == "dt_bias":
            return rng.uniform(-4.0, 1.0, spec.shape).astype(np.float32)
        if name in ("D", "scale"):
            return (1.0 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        std = spec.scale or 1.0 / np.sqrt(max(np.prod(spec.shape[:-1]), 1))
        return (std * rng.standard_normal(spec.shape)).astype(np.float32)

    def walk(t, name=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return draw(name, t)

    return walk(tssm.mamba_params(tcfg))


def _x(cfg, s, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [12, 32, 2])
def test_mamba_block_matches_the_reference(S):
    jcfg, tcfg = _cfgs()
    p = _np_params(tcfg)
    x = _x(tcfg, S)
    jout, jstate = jssm.mamba_block(_jax_tree(p), jnp.asarray(x), jcfg,
                                    make_ctx(jcfg, None, "prefill", DistConfig()))
    with torch.inference_mode():
        tout, tstate = tssm.mamba_block(params_from_numpy(p, CPU), torch.from_numpy(x), tcfg,
                                        Ctx(dtype=torch.float32))
    assert tuple(tout.shape) == (B, S, tcfg.d_model)
    assert tuple(tstate["h"].shape) == (B, tcfg.mamba_d_inner, tcfg.mamba_d_state)
    assert tuple(tstate["conv"].shape) == (B, tcfg.mamba_d_conv - 1, tcfg.mamba_d_inner)
    assert tstate["h"].dtype == torch.float32
    _close(tout, jout)
    _close(tstate["h"], jstate["h"])
    _close(tstate["conv"], jstate["conv"])
    if S < tcfg.mamba_d_conv - 1:
        assert not tstate["conv"][:, : tcfg.mamba_d_conv - 1 - S].any()


def test_mamba_decode_block_matches_the_reference_over_chained_steps():
    jcfg, tcfg = _cfgs()
    p = _np_params(tcfg)
    S, steps = 12, 4
    jp, tp = _jax_tree(p), params_from_numpy(p, CPU)
    _, jcache = jssm.mamba_block(jp, jnp.asarray(_x(tcfg, S)), jcfg,
                                 make_ctx(jcfg, None, "prefill", DistConfig()))
    tcache = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jcache.items()}
    dctx = make_ctx(jcfg, None, "decode", DistConfig(decode_seqpar=False))
    xs = _x(tcfg, steps, seed=2)
    with torch.inference_mode():
        for i in range(steps):
            jout, jcache = jssm.mamba_decode_block(jp, jnp.asarray(xs[:, i:i + 1]), jcfg, dctx,
                                                   cache=jcache, pos=jnp.int32(S + i))
            tout, tcache = tssm.mamba_decode_block(
                tp, torch.from_numpy(xs[:, i:i + 1]), tcfg, Ctx(dtype=torch.float32),
                cache=tcache, pos=torch.tensor([S + i]))
            assert tuple(tout.shape) == (B, 1, tcfg.d_model)
            _close(tout, jout)
            _close(tcache["h"], jcache["h"])
            _close(tcache["conv"], jcache["conv"])


@pytest.mark.parametrize("S", [2, 12, 16])
def test_prefill_then_decode_equals_the_full_forward(S):
    """The prefill of S positions, then k one-token steps, give the full
    forward's outputs at positions S..S+k-1 and its final state."""
    _, cfg = _cfgs()
    tp = params_from_numpy(_np_params(cfg), CPU)
    k = 5
    x = torch.from_numpy(_x(cfg, S + k))
    ctx = Ctx(dtype=torch.float32)
    with torch.inference_mode():
        full, fstate = tssm.mamba_block(tp, x, cfg, ctx)
        _, cache = tssm.mamba_block(tp, x[:, :S], cfg, ctx)
        for i in range(k):
            out, cache = tssm.mamba_decode_block(tp, x[:, S + i:S + i + 1], cfg, ctx,
                                                 cache=cache, pos=torch.tensor([S + i]))
            torch.testing.assert_close(out[:, 0], full[:, S + i], **TOL)
    torch.testing.assert_close(cache["h"], fstate["h"], **TOL)
    torch.testing.assert_close(cache["conv"], fstate["conv"], **TOL)


def test_chunk_checkpoint_changes_no_gradient():
    """S = 40: two full chunks and a short one.  The gradients of every
    parameter and of the input, with each chunk checkpointed and without,
    bit-equal; and equal to ``jax.grad`` of the reference's at 1e-4."""
    jcfg, tcfg = _cfgs()
    p = _np_params(tcfg)
    x = _x(tcfg, 40)
    w = np.random.default_rng(3).standard_normal((B, 40, tcfg.d_model)).astype(np.float32)

    def jloss(jp, jx):
        out, state = jssm.mamba_block(jp, jx, jcfg, make_ctx(jcfg, None, "train", DistConfig()))
        return jnp.sum(out * w) + jnp.sum(state["h"])

    jgrads = jax.grad(jloss, argnums=(0, 1))(_jax_tree(p), jnp.asarray(x))
    want = [np.asarray(g) for g in jax.tree.leaves(jgrads[0])] + [np.asarray(jgrads[1])]
    got = []
    for remat in (True, False):
        tp = params_from_numpy(p, CPU)
        leaves = [t.requires_grad_() for t in tree_leaves(tp)]
        tx = torch.from_numpy(x).requires_grad_()
        out, state = tssm.mamba_block(tp, tx, tcfg, Ctx(dtype=torch.float32, remat=remat))
        loss = (out * torch.from_numpy(w)).sum() + state["h"].sum()
        got.append(torch.autograd.grad(loss, leaves + [tx]))
    for a, b in zip(*got):
        assert torch.equal(a, b)
    assert len(got[0]) == len(want)
    for g, w_ in zip(got[0], want):
        np.testing.assert_allclose(g.numpy(), w_, **TOL)


def test_cast_params_keeps_a_log_d_and_dt_bias_in_f32():
    _, tcfg = _cfgs()
    p = params_from_numpy(_np_params(tcfg), CPU)
    cast = cast_params(p, torch.bfloat16)
    for name in ("A_log", "D", "dt_bias"):
        assert cast[name].dtype == torch.float32 and torch.equal(cast[name], p[name])
    for name in ("dt_norm", "b_norm", "c_norm"):
        assert cast[name]["scale"].dtype == torch.float32
    for name in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "out_proj"):
        assert cast[name].dtype == torch.bfloat16
        assert torch.equal(cast[name], p[name].to(torch.bfloat16))
