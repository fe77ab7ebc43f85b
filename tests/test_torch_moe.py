"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
reference's ``repro/models/moe.py``, on one device.

``moe_ref`` runs on the reference's own ``init_params`` arrays, carried
across by ``params_from_numpy``, and f32 activations drawn from a seed:
the output and the Switch aux loss agree at 1e-5, and the router picks the
same experts in the same order (no two of these f32 routing probabilities
tie, so ``torch.topk`` and ``jax.lax.top_k`` cannot order a tie apart).
The routing statistics (``coactivation_counts``, ``dispatch_bytes``) are
exact counts and equal the reference's exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jreg
from repro.launch.steps import DistConfig, make_ctx
from repro.models import moe as jM
from repro.models.params import init_params as jinit_params
from repro_torch.configs import registry as treg
from repro_torch.core.placement import random_placement, synth_coactivation
from repro_torch.models import moe as tM
from repro_torch.models.layers import Ctx
from repro_torch.models.params import init_params, params_from_numpy, tree_leaves

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
# granite-moe: 8 experts top-2, no shared expert (reduced); deepseek-moe: 8
# experts top-2 and one shared expert (reduced)
ARCHS = ["granite_moe_3b_a800m", "deepseek_moe_16b"]


def _cfgs(arch, **extra):
    extra = dict(activation_dtype="float32", **extra)
    return (dataclasses.replace(jreg.get_config(arch).smoke(), **extra),
            dataclasses.replace(treg.get_config(arch).smoke(), **extra))


def _params(jcfg, seed=0):
    jp = jinit_params(jM.moe_params(jcfg, 1), jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _x(cfg, B=2, S=9, seed=3):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ref_output_aux_and_experts_match_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    assert bool(tcfg.n_shared_experts) == (arch == "deepseek_moe_16b")
    jp, tp = _params(jcfg)
    x = _x(jcfg)
    jctx = make_ctx(jcfg, None, "prefill", DistConfig())
    jout, jaux = jM.moe_ref(jp, jnp.asarray(x), jcfg, jctx)
    with torch.inference_mode():
        tout, taux = tM.moe_ref(tp, torch.from_numpy(x), tcfg, Ctx(dtype=torch.float32))
        _, tidx, _ = tM._router(tp, torch.from_numpy(x).reshape(-1, tcfg.d_model), tcfg)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    _, jidx, _ = jM._router(jp, jnp.asarray(x).reshape(-1, jcfg.d_model), jcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ref_matches_the_reference_at_published_expert_counts(arch):
    """The published expert count and top-k (granite-moe 40 top-8, deepseek-moe
    64 top-6 with 2 shared experts) at the reduced width."""
    full = treg.get_config(arch)
    keep = dict(n_experts=full.n_experts, top_k=full.top_k,
                n_shared_experts=full.n_shared_experts)
    jcfg, tcfg = _cfgs(arch, **keep)
    jp, tp = _params(jcfg, seed=1)
    x = _x(jcfg, B=3, S=5, seed=4)
    jout, jaux = jM.moe_ref(jp, jnp.asarray(x), jcfg,
                            make_ctx(jcfg, None, "prefill", DistConfig()))
    with torch.inference_mode():
        tout, taux = tM.moe_ref(tp, torch.from_numpy(x), tcfg, Ctx(dtype=torch.float32))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("tp", [1, 16])
def test_moe_param_tree_matches_the_reference(tp):
    """Expert weights padded to a multiple of ``tp`` (granite-moe's 40 to 48),
    the router over the real experts only."""
    cfg = treg.get_config("granite_moe_3b_a800m")
    jshapes = [s.shape for s in jax.tree.leaves(jM.moe_params(jreg.get_config(
        "granite_moe_3b_a800m"), tp), is_leaf=lambda x: hasattr(x, "axes"))]
    assert [s.shape for s in tree_leaves(tM.moe_params(cfg, tp))] == jshapes
    assert tM.padded_experts(40, tp) == jM.padded_experts(40, tp) == (40 if tp == 1 else 48)


def test_moe_apply_is_moe_ref_on_one_device_and_raises_on_a_mesh():
    _, tcfg = _cfgs("deepseek_moe_16b")
    tp = init_params(tM.moe_params(tcfg), torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(tcfg))
    ctx = Ctx(dtype=torch.float32)
    with torch.inference_mode():
        got, want = tM.moe_apply(tp, x, tcfg, ctx), tM.moe_ref(tp, x, tcfg, ctx)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        one = Ctx(dtype=torch.float32, mesh=types.SimpleNamespace(shape={"model": 1}))
        assert torch.equal(tM.moe_apply(tp, x, tcfg, one)[0], want[0])
        sharded = Ctx(dtype=torch.float32, mesh=types.SimpleNamespace(shape={"model": 4}))
        with pytest.raises(NotImplementedError, match="queue 1, item 9"):
            tM.moe_apply(tp, x, tcfg, sharded)


def test_moe_ref_keeps_the_activation_dtype():
    _, tcfg = _cfgs("granite_moe_3b_a800m")
    tp = init_params(tM.moe_params(tcfg), torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(tcfg)).to(torch.bfloat16)
    with torch.inference_mode():
        out, aux = tM.moe_ref(tp, x, tcfg, Ctx())
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.isfinite(out.float()).all() and float(aux) > 0


@pytest.mark.parametrize("E,k,T", [(8, 2, 64), (40, 8, 512), (64, 6, 2048)])
def test_coactivation_counts_equal_the_reference(E, k, T):
    _, idx = synth_coactivation(E, k, T, n_clusters=4, seed=E)
    got = tM.coactivation_counts(torch.from_numpy(idx), E)
    want = np.asarray(jM.coactivation_counts(jnp.asarray(idx), E))
    assert got.dtype == torch.float32 and tuple(got.shape) == (E, E)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(np.diag(want) == 0) and want.sum() > 0


@pytest.mark.parametrize("E,k,T,shards", [(40, 8, 512, 16), (64, 6, 2048, 16), (8, 2, 64, 3)])
def test_dispatch_bytes_equal_the_reference(E, k, T, shards):
    _, idx = synth_coactivation(E, k, T, n_clusters=4, seed=1)
    e2s = random_placement(E, shards, seed=0).expert_to_shard
    got = tM.dispatch_bytes(torch.from_numpy(idx), torch.from_numpy(e2s), 2048)
    want = jM.dispatch_bytes(jnp.asarray(idx), jnp.asarray(e2s), 2048)
    assert got.dtype == torch.float32
    assert float(got) == float(want)
    assert float(tM.dispatch_bytes(torch.from_numpy(idx), torch.from_numpy(e2s), 2048,
                                   bytes_per=4)) == float(
        jM.dispatch_bytes(jnp.asarray(idx), jnp.asarray(e2s), 2048, bytes_per=4))
