"""The port's multi-rank model paths over ``torch.distributed`` against the
JAX reference: the expert-parallel MoE (``moe_ep``, ``moe_ep_dedup``,
``expert_perm``), sequence-parallel flash decode (``decode_attn_seqpar``)
and a 2-layer MoE model's prefill and decode across ranks.

Four CPU processes, gloo, rendezvous through a ``file://`` store under
``tmp_path``, form a (data 2, model 2) mesh (and, for decode with a middle
shard, a (data 1, model 4) one; and a (data 4, model 1) one, where
``moe_apply`` takes ``moe_ref``).  Each rank runs every case once on its own
blocks under ``DECODE_RULES`` (``Ctx``'s contract: its ``E/tp`` experts,
its ``mlp`` block of the shared expert, its query and key/value heads, its
sequence shard of each cache) and saves them; the tests below read the
saved blocks.  The ranks are joined under one time limit: a rank that hangs fails
the module, it never runs the suite into its own limit.

The references: ``moe_ref``, ``decode_attn_dense`` and the unsharded
``prefill`` + ``decode_step`` in this process; the reference's own
``moe_ep`` and ``moe_ep_dedup`` need a mesh, so one JAX subprocess with 4
forced host devices runs them on a (2, 2) mesh (this file as a script) and
writes an ``.npz``.  Where tokens are dropped (capacity factor 1.25) only
that parity tests the drop rule: ``moe_ref`` is dropless.  Tolerances are
the reference suite's (``tests/test_multidevice.py``): 2e-4 against the
dropless and dense paths, 1e-5 against the reference's own EP outputs.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jreg
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.launch.steps import DistConfig, make_ctx
from repro.models import layers as jL
from repro.models import moe as jM
from repro.models import transformer as jT
from repro.models.params import init_params as jinit_params
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.placement import place_experts
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as tL
from repro_torch.models import moe as tM
from repro_torch.models import transformer as tT
from repro_torch.models.layers import Ctx
from repro_torch.models.params import params_from_numpy
from repro_torch.parallel.sharding import (DECODE_RULES, batch_block, dp_axes, shard_tree,
                                           tree_shardings)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
WORLD = 4
RANK_TIMEOUT_S = 120
REFERENCE_TIMEOUT_S = 120
MOE_TOL = dict(rtol=2e-4, atol=2e-4)
EP_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# the reference suite's permutations (tests/test_multidevice.py): physical
# slot of each logical expert
PERM_EP = [3, 2, 1, 0, 7, 6, 5, 4]
PERM_DEDUP = [0, 4, 1, 5, 2, 6, 3, 7]
# decode: (B, S, K, G, hd), 4 key/value heads to split over the (1, 4)
# line; positions in the first shard of the (1, 4) mesh (shards of 16: the
# others attend over none of theirs), at the first of its third (a shard
# boundary), in a middle one and at the last; caps 0 and 5
DECODE = (4, 64, 4, 2, 16)
DECODE_POS = (5, 32, 37, 63)
DECODE_CAPS = (0.0, 5.0)
# the 2-layer MoE model through the sharded serving steps: 2 prompts of 6
# tokens, a cache of 16, 4 greedy decode steps (positions 6-9 cross from the
# first cache shard of 8 into the second).  Each rank routes 1 x 3 tokens, fewer than the capacity's
# floor of 4, so no expert can overflow and the EP prefill is dropless,
# like the unsharded reference
MODEL_B, MODEL_S, MODEL_CACHE, MODEL_STEPS = 2, 6, 16, 4


def _moe_cfg(pkg_cfg, pkg_spec, top_k):
    """The reference suite's MoE unit: d 32, 8 experts, one shared expert."""
    return pkg_cfg(name="t", family="m", d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
                   d_ff=64, vocab=64, unit=(pkg_spec("attn", "moe"),), n_experts=8,
                   top_k=top_k, moe_d_ff=16, n_shared_experts=1, activation_dtype="float32")


def _moe_inputs():
    """Reference parameters (from ``jax.random``) and x (4, 8, 32), numpy."""
    jcfg = _moe_cfg(JModelConfig, JLayerSpec, 2)
    jp = jinit_params(jM.moe_params(jcfg, tp=2), jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal((4, 8, 32)).astype(np.float32)
    return jax.tree.map(np.asarray, jp), x


def _permuted(p, perm):
    """Expert weights laid out so that slot perm[e] holds expert e."""
    inv = np.argsort(np.asarray(perm))
    return {k: (v[inv] if k in ("w_gate", "w_up", "w_down") else v) for k, v in p.items()}


def _model_cfgs():
    def cut(cfg):
        return dataclasses.replace(cfg.smoke(), n_layers=2, activation_dtype="float32")
    return cut(jreg.get_config("granite_moe_3b_a800m")), \
        cut(treg.get_config("granite_moe_3b_a800m"))


def _decode_inputs(B, seed=3):
    _, S, K, G, hd = DECODE
    rng = np.random.default_rng(seed)
    shapes = ((B, K * G, hd), (B, S, K, hd), (B, S, K, hd), (B, K, hd), (B, K, hd))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# each rank
# ---------------------------------------------------------------------------

def _counted(module, name, counts):
    """Wrap ``module.name`` to count its calls in ``counts[name]``."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        counts[name] += 1
        return fn(*a, **kw)

    setattr(module, name, wrapped)


def _rank(rank: int, store: str, inputs_path: str, out_dir: str, model_cfg) -> None:
    torch.distributed.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                         world_size=WORLD)
    try:
        torch.set_num_threads(1)
        inp = torch.load(inputs_path, weights_only=True)
        mesh = make_mesh((2, 2), ("data", "model"))
        line = make_mesh((1, 4), ("data", "model"))
        col = make_mesh((4, 1), ("data", "model"))
        out = {"axes": torch.tensor([mesh.axis_index("data"), mesh.axis_index("model"),
                                     line.axis_index("model"), col.axis_index("data")])}
        x = inp["x"][batch_block(mesh, inp["x"].shape[0])]
        ctx = Ctx(dtype=torch.float32, mesh=mesh, rules=DECODE_RULES)
        cfg2, cfg3 = (_moe_cfg(ModelConfig, LayerSpec, k) for k in (2, 3))

        def blocks(p, m):
            """The rank's blocks of the whole MoE weights on mesh ``m``."""
            return shard_tree(p, tree_shardings(tM.moe_params(cfg2, tp=m.shape["model"]), m,
                                                DECODE_RULES))

        p, pe, pd = (blocks(inp[k], mesh) for k in ("moe", "moe_perm_ep", "moe_perm_dedup"))
        pp, place = blocks(inp["moe_place"], mesh), inp["place_perm"]
        with torch.inference_mode():
            out["ep8"] = tM.moe_ep(p, x, cfg2, ctx, capacity_factor=8.0)
            out["ep125"] = tM.moe_ep(p, x, cfg2, ctx, capacity_factor=1.25)
            out["ep8_perm"] = tM.moe_ep(pe, x, cfg2, ctx, capacity_factor=8.0,
                                        expert_perm=torch.tensor(PERM_EP))
            out["dd8"] = tM.moe_ep_dedup(p, x, cfg3, ctx, dest_k=3.0, capacity_factor=8.0)
            out["dd8_perm"] = tM.moe_ep_dedup(pd, x, cfg3, ctx, dest_k=3.0, capacity_factor=8.0,
                                              expert_perm=torch.tensor(PERM_DEDUP))
            out["dd125"] = tM.moe_ep_dedup(p, x, cfg3, ctx)
            out["dd_ident"] = tM.moe_ep_dedup(p, x, cfg2, ctx, capacity_factor=8.0)
            out["dd_place"] = tM.moe_ep_dedup(pp, x, cfg2, ctx, capacity_factor=8.0,
                                              expert_perm=place)
            out["apply"] = tM.moe_apply(p, x, cfg2, ctx)
            out["apply_dedup"] = tM.moe_apply(p, x, cfg3, dataclasses.replace(ctx, moe_dedup=True))
            out["apply_decode"] = tM.moe_apply(p, x[:, :1], cfg2, ctx)
            xc = inp["x"][batch_block(col, inp["x"].shape[0])]
            cctx = Ctx(dtype=torch.float32, mesh=col, rules=DECODE_RULES)
            pc = blocks(inp["moe"], col)
            out["apply_col"] = tM.moe_apply(pc, xc, cfg2, cctx)
            out["apply_col_dedup"] = tM.moe_apply(pc, xc, cfg3,
                                                  dataclasses.replace(cctx, moe_dedup=True))

            for name, m in (("mesh", mesh), ("line", line)):
                for B in (DECODE[0], 1):
                    blk = batch_block(m, B)
                    tp, mi = m.shape["model"], m.axis_index("model")
                    for pos in DECODE_POS:
                        for cap in DECODE_CAPS:
                            q, ck, cv, kn, vn = (t[blk] for t in inp[f"decode_B{B}"])
                            # the rank's query and key/value heads, its sequence shard
                            Hl, Kl, S_loc = q.shape[1] // tp, kn.shape[1] // tp, ck.shape[1] // tp
                            q = q[:, mi * Hl:(mi + 1) * Hl]
                            kn, vn = (t[:, mi * Kl:(mi + 1) * Kl] for t in (kn, vn))
                            ck = ck[:, mi * S_loc:(mi + 1) * S_loc].clone()
                            cv = cv[:, mi * S_loc:(mi + 1) * S_loc].clone()
                            dctx = Ctx(dtype=torch.float32, mesh=m, rules=DECODE_RULES,
                                       decode_seqpar=True)
                            o, (ck2, cv2) = tL.decode_attn_seqpar(
                                q, ck, cv, kn, vn, torch.tensor([pos]), ctx=dctx, logit_cap=cap)
                            assert ck2 is ck and cv2 is cv   # written in place
                            out[f"dec_{name}_B{B}_{pos}_{cap:g}"] = (o, ck, cv)

            counts = {"moe_ep": 0, "decode_attn_seqpar": 0}
            _counted(tM, "moe_ep", counts)
            _counted(tL, "decode_attn_seqpar", counts)
            prefill, p_specs, pctx = tsteps.make_prefill_step(model_cfg, mesh,
                                                              cache_len=MODEL_CACHE)
            decode, _, _, _ = tsteps.make_decode_step(model_cfg, mesh, tsteps.DistConfig(),
                                                      MODEL_B, MODEL_CACHE)
            params = shard_tree(inp["model"], tree_shardings(p_specs, mesh, pctx.rules))
            tokens = inp["tokens"][batch_block(mesh, MODEL_B)]
            cache, logits = prefill(params, {"tokens": tokens})
            n_ep = counts["moe_ep"]
            steps = [logits]
            for i in range(MODEL_STEPS):
                logits, cache = decode(params, cache, logits.argmax(-1), MODEL_S + i)
                steps.append(logits)
            out["model_logits"] = torch.stack(steps)
            out["model_cache_k"] = cache["unit"]["l0"]["k"]
            out["model_counts"] = torch.tensor([n_ep, counts["moe_ep"] - n_ep,
                                                counts["decode_attn_seqpar"]])
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _run_ranks(tmp: Path, inputs_path: Path, model_cfg) -> list[dict]:
    """Start the 4 ranks, join them under one time limit, kill any left."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "store"), str(inputs_path), str(tmp),
                                             model_cfg))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung, f"{len(hung)} ranks still running after {RANK_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# the reference's EP on a (2, 2) mesh of forced host devices (a subprocess)
# ---------------------------------------------------------------------------

def _reference_ep(out_path: str) -> None:
    from repro import compat
    from repro.parallel.sharding import TRAIN_RULES

    mesh = jax.make_mesh((2, 2), ("data", "model"))
    ctx = jL.Ctx(rules=TRAIN_RULES, dtype=jnp.float32, mesh=mesh)
    p, x = _moe_inputs()
    cfg2, cfg3 = (_moe_cfg(JModelConfig, JLayerSpec, k) for k in (2, 3))
    with compat.set_mesh(mesh):
        ep, ep_aux = jax.jit(lambda p, x: jM.moe_ep(p, x, cfg2, ctx, capacity_factor=1.25))(p, x)
        dd, dd_aux = jax.jit(lambda p, x: jM.moe_ep_dedup(p, x, cfg3, ctx))(p, x)
    np.savez(out_path, ep125=np.asarray(ep), ep125_aux=np.asarray(ep_aux),
             dd125=np.asarray(dd), dd125_aux=np.asarray(dd_aux))


def _start_reference(out_path: Path) -> subprocess.Popen:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, __file__, "--reference", str(out_path)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


# ---------------------------------------------------------------------------
# the run, once per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    ref = _start_reference(tmp / "reference.npz")
    try:
        p_np, x = _moe_inputs()
        jcfg, tcfg = _model_cfgs()
        jparams = jinit_params(jT.model_param_specs(jcfg, tp=1), jax.random.PRNGKey(0))
        tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (MODEL_B, MODEL_S),
                                                   dtype=np.int32)
        # the placement: the router's choices over every token, partitioned
        p = params_from_numpy(p_np, CPU)
        with torch.inference_mode():
            _, idx, _ = tM._router(p, torch.from_numpy(x).reshape(-1, 32),
                                   _moe_cfg(ModelConfig, LayerSpec, 2))
        placement = place_experts(tM.coactivation_counts(idx, 8).numpy(), 2)
        inputs = {
            "x": torch.from_numpy(x), "moe": p,
            "moe_perm_ep": params_from_numpy(_permuted(p_np, PERM_EP), CPU),
            "moe_perm_dedup": params_from_numpy(_permuted(p_np, PERM_DEDUP), CPU),
            "moe_place": params_from_numpy(_permuted(p_np, placement.perm), CPU),
            "place_perm": torch.from_numpy(placement.perm),
            "model": params_from_numpy(jax.tree.map(np.asarray, jparams), CPU),
            "tokens": torch.from_numpy(tokens),
            **{f"decode_B{B}": [torch.from_numpy(a) for a in _decode_inputs(B)]
               for B in (DECODE[0], 1)},
        }
        torch.save(inputs, tmp / "inputs.pt")
        ranks = _run_ranks(tmp, tmp / "inputs.pt", tcfg)
        stdout, stderr = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr[-3000:]
    return {"ranks": ranks, "reference": dict(np.load(tmp / "reference.npz")), "x": x,
            "p": p_np, "idx": idx, "placement": placement, "inputs": inputs,
            "jcfg": jcfg, "tcfg": tcfg, "jparams": jparams, "tokens": tokens}


def _data_block(run, r, n):
    """Rank r's block of a batch of n on the (2, 2) mesh."""
    d = int(run["ranks"][r]["axes"][0])
    return slice(d * n // 2, (d + 1) * n // 2)


def _moe_ref(run, top_k):
    jcfg = _moe_cfg(JModelConfig, JLayerSpec, top_k)
    ctx = make_ctx(jcfg, None, "prefill", DistConfig())
    out, aux = jM.moe_ref(jax.tree.map(jnp.asarray, run["p"]), jnp.asarray(run["x"]), jcfg, ctx)
    return np.asarray(out), float(aux)


def _blocks(run, key):
    """Each rank's (out, aux) of ``key`` beside the x rows it holds; the two
    model ranks of a data block hold the same bits."""
    got = []
    for r, res in enumerate(run["ranks"]):
        out, aux = res[key]
        got.append((_data_block(run, r, 4), out.numpy(), float(aux)))
    for (b0, o0, a0), (b1, o1, a1) in zip(got[::2], got[1::2]):
        assert b0 == b1 and np.array_equal(o0, o1) and a0 == a1
    return got


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

class _Axes:
    """A stand-in mesh: its axis sizes and this rank's coordinates."""

    def __init__(self, shape, coords):
        self.shape, self.axis_names, self._coords = shape, tuple(shape), coords

    def axis_index(self, axis):
        return self._coords[axis]


def test_mesh_axes_and_batch_blocks(run):
    axes = [tuple(int(a) for a in res["axes"]) for res in run["ranks"]]
    # rank r at its row-major coordinate of (data 2, model 2), (1, 4) and (4, 1)
    assert axes == [(0, 0, 0, 0), (0, 1, 1, 1), (1, 0, 2, 2), (1, 1, 3, 3)]
    # a batch shards over the data axes that divide it, in order
    pod = {"pod": 2, "data": 3, "model": 2}
    assert dp_axes(_Axes(pod, {})) == ("pod", "data")
    assert [batch_block(_Axes(pod, {"pod": p, "data": d}), 12)
            for p in range(2) for d in range(3)] == [slice(2 * i, 2 * i + 2) for i in range(6)]
    # 4 divides by pod 2 but not by data 3; a batch of 1 replicates
    assert batch_block(_Axes(pod, {"pod": 1, "data": 2}), 4) == slice(2, 4)
    assert batch_block(_Axes(pod, {"pod": 1, "data": 2}), 1) == slice(0, 1)


@pytest.mark.parametrize("key,perm", [("ep8", None), ("ep8_perm", PERM_EP)])
def test_moe_ep_matches_moe_ref_at_ample_capacity(run, key, perm):
    """Capacity factor 8: nothing is dropped, so EP is the dropless
    ``moe_ref`` (with ``expert_perm`` and the weights laid out to match,
    the same output)."""
    want, _ = _moe_ref(run, 2)
    for blk, out, _ in _blocks(run, key):
        np.testing.assert_allclose(out, want[blk], **MOE_TOL)


def test_moe_ep_drops_as_the_reference_does(run):
    """Capacity factor 1.25: each rank's 8 tokens x top-2 over 8 experts
    fill buckets of the floor, 4, and some overflow; the kept set, the
    combine and the aux loss (averaged over "model" and then "data") are the
    reference's own EP's."""
    ref = run["reference"]
    dropless, _ = _moe_ref(run, 2)
    assert np.abs(ref["ep125"] - dropless).max() > 1e-3   # tokens were dropped
    for blk, out, aux in _blocks(run, "ep125"):
        np.testing.assert_allclose(out, ref["ep125"][blk], **EP_TOL)
        np.testing.assert_allclose(aux, float(ref["ep125_aux"]), rtol=1e-6)


@pytest.mark.parametrize("key", ["dd8", "dd8_perm"])
def test_moe_ep_dedup_matches_moe_ref_at_ample_capacity(run, key):
    want, _ = _moe_ref(run, 3)
    for blk, out, _ in _blocks(run, key):
        np.testing.assert_allclose(out, want[blk], **MOE_TOL)


def test_moe_ep_dedup_drops_as_the_reference_does(run):
    ref = run["reference"]
    dropless, _ = _moe_ref(run, 3)
    assert np.abs(ref["dd125"] - dropless).max() > 1e-3   # tokens were dropped
    for blk, out, aux in _blocks(run, "dd125"):
        np.testing.assert_allclose(out, ref["dd125"][blk], **EP_TOL)
        np.testing.assert_allclose(aux, float(ref["dd125_aux"]), rtol=1e-6)


def test_graph_partition_placement_keeps_the_output_and_cuts_dispatch(run):
    """``place_experts`` on the router's co-activation counts: the deduped
    EP output does not move, and the bytes a deduplicated dispatch sends
    are no more than under the identity placement (experts 0-3 on rank 0)."""
    for (blk, out, _), (blk0, out0, _) in zip(_blocks(run, "dd_place"), _blocks(run, "dd_ident")):
        assert blk == blk0
        np.testing.assert_allclose(out, out0, **MOE_TOL)
    idx, pl = run["idx"], run["placement"]
    placed = tM.dispatch_bytes(idx, torch.from_numpy(pl.expert_to_shard), 32)
    identity = tM.dispatch_bytes(idx, torch.arange(8) // 4, 32)
    assert float(placed) <= float(identity)
    assert sorted(pl.perm.tolist()) == list(range(8))


def test_moe_apply_dispatches_as_the_reference(run):
    """On a "model" axis of 2: ``moe_ep`` for a sequence of 8 (the same
    bits), ``moe_ep_dedup`` under ``moe_dedup``, ``moe_ref`` for one token
    (each rank's experts, the combine summed over "model": the one-device
    ``moe_ref`` at 1e-5)."""
    for r, res in enumerate(run["ranks"]):
        for key, want in (("apply", "ep125"), ("apply_dedup", "dd125")):
            assert torch.equal(res[key][0], res[want][0]) and torch.equal(res[key][1],
                                                                         res[want][1])
        blk = _data_block(run, r, 4)
        p = run["inputs"]["moe"]
        x = run["inputs"]["x"][blk, :1]
        with torch.inference_mode():
            want = tM.moe_ref(p, x, _moe_cfg(ModelConfig, LayerSpec, 2), Ctx(dtype=torch.float32))
        np.testing.assert_allclose(res["apply_decode"][0].numpy(), want[0].numpy(), **EP_TOL)


def test_moe_apply_on_a_model_axis_of_one_is_moe_ref(run):
    """On a (data 4, model 1) mesh each rank routes its own row through
    ``moe_ref``, its output bit for bit, under ``moe_dedup`` too; the aux
    loss is the whole batch's (its means taken over "data"), as the one
    device's over the 4 rows, up to the sum order."""
    p = run["inputs"]["moe"]
    for r, res in enumerate(run["ranks"]):
        x = run["inputs"]["x"][r:r + 1]
        for key, k in (("apply_col", 2), ("apply_col_dedup", 3)):
            cfg = _moe_cfg(ModelConfig, LayerSpec, k)
            with torch.inference_mode():
                want, _ = tM.moe_ref(p, x, cfg, Ctx(dtype=torch.float32))
                _, want_aux = tM.moe_ref(p, run["inputs"]["x"], cfg, Ctx(dtype=torch.float32))
            assert torch.equal(res[key][0], want), (r, key)
            np.testing.assert_allclose(float(res[key][1]), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("mesh", ["mesh", "line"])
@pytest.mark.parametrize("B", [DECODE[0], 1])
@pytest.mark.parametrize("pos", DECODE_POS)
@pytest.mark.parametrize("cap", DECODE_CAPS)
def test_decode_attn_seqpar_matches_dense(run, mesh, B, pos, cap):
    """The (2, 2) mesh (shards of 32; the batch of 4 split over "data", a
    batch of 1 replicated) and the (1, 4) line (shards of 16: positions 5,
    32, 37 and 63 in the first, at the start of the third, in a middle one
    and in the last), each rank with its query and key/value heads: its
    heads of ``o`` against ``decode_attn_dense`` at 2e-4, the shards of the
    written cache at 1e-5."""
    q, ck, cv, kn, vn = (jnp.asarray(a) for a in _decode_inputs(B))
    o, (dk, dv) = jL.decode_attn_dense(q, ck, cv, kn, vn, jnp.int32(pos), logit_cap=cap)
    o, dk, dv = np.asarray(o), np.asarray(dk), np.asarray(dv)
    tp = 2 if mesh == "mesh" else 4
    S_loc = DECODE[1] // tp
    seen = set()
    for r, res in enumerate(run["ranks"]):
        mi = int(res["axes"][1 if mesh == "mesh" else 2])
        blk = _data_block(run, r, B) if mesh == "mesh" and B % 2 == 0 else slice(0, B)
        got_o, got_k, got_v = (t.numpy() for t in res[f"dec_{mesh}_B{B}_{pos}_{cap:g}"])
        shard = slice(mi * S_loc, (mi + 1) * S_loc)
        Hl = o.shape[1] // tp
        np.testing.assert_allclose(got_o, o[blk, mi * Hl:(mi + 1) * Hl], **MOE_TOL)
        np.testing.assert_allclose(got_k, dk[blk, shard], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_v, dv[blk, shard], rtol=1e-5, atol=1e-5)
        seen.add((blk.start, mi))
    assert len(seen) == (WORLD if mesh == "line" or B > 1 else tp)


def test_moe_model_prefill_and_decode_across_ranks(run):
    """A 2-layer reduced granite-moe-3b-a800m in f32, the reference's
    parameters cut into each rank's blocks, through ``make_prefill_step``
    and ``make_decode_step`` on the (2, 2) mesh: its prefill takes the EP
    path (S 6 >= tp 2) once a layer and hands decode its caches sequence-
    sharded over "model", its decode steps ``decode_attn_seqpar`` once a
    layer and ``moe_ref`` on the rank's experts (one token).  Logits of the
    prefill and of 4 greedy steps against the port's one-process run and
    the reference's unsharded prefill + ``decode_step`` at 1e-4, greedy
    tokens equal."""
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    tokens, jparams = run["tokens"], run["jparams"]
    pctx = make_ctx(jcfg, None, "prefill", DistConfig())
    dctx = make_ctx(jcfg, None, "decode", DistConfig(decode_seqpar=False))
    jcache, jl = jT.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, pctx,
                            cache_len=MODEL_CACHE)
    ref = [np.asarray(jl)]
    for i in range(MODEL_STEPS):
        jl, jcache = jT.decode_step(jparams, jcache, jnp.argmax(jl, -1).astype(jnp.int32),
                                    jnp.int32(MODEL_S + i), jcfg, dctx)
        ref.append(np.asarray(jl))
    ref = np.stack(ref)
    ctx = Ctx(dtype=torch.float32)
    params = run["inputs"]["model"]
    with torch.inference_mode():
        cache, tl = tT.prefill(params, {"tokens": torch.from_numpy(tokens)}, tcfg, ctx,
                               cache_len=MODEL_CACHE)
        one = [tl]
        for i in range(MODEL_STEPS):
            tl, cache = tT.decode_step(params, cache, tl.argmax(-1), MODEL_S + i, tcfg, ctx)
            one.append(tl)
    one = torch.stack(one).numpy()
    np.testing.assert_allclose(one, ref, **MODEL_TOL)
    S_loc = MODEL_CACHE // 2
    for r, res in enumerate(run["ranks"]):
        blk = _data_block(run, r, MODEL_B)
        assert res["model_counts"].tolist() == [2, 0, 2 * MODEL_STEPS]
        got = res["model_logits"].numpy()
        np.testing.assert_allclose(got, ref[:, blk], **MODEL_TOL)
        np.testing.assert_allclose(got, one[:, blk], **MODEL_TOL)
        np.testing.assert_array_equal(got.argmax(-1), ref[:, blk].argmax(-1))
        mi = int(res["axes"][1])
        np.testing.assert_allclose(res["model_cache_k"].numpy(),
                                   cache["unit"]["l0"]["k"][:, blk, mi * S_loc:(mi + 1) * S_loc]
                                   .numpy(), rtol=1e-5, atol=1e-5)


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference_ep(sys.argv[2])
