"""The port's sharded train step (``launch/steps.py::make_train_step`` on a
mesh, ``launch/train.py::train``) over ``torch.distributed``: Megatron
tensor parallelism, sequence parallelism, FSDP (ZeRO-3) and the
expert-parallel MoE, with the gradients through the collectives.

Four CPU processes, gloo, rendezvous through a ``file://`` store under
``tmp_path``, once for the module: each rank builds a (data 2, model 2) and
a (data 1, model 4) mesh (and a (data 4, model 1) one, pure data
parallelism, where the MoE is ``moe_ref`` with the whole batch's aux loss)
and runs every case on its blocks; the tests below
read what the ranks saved.  The rank processes import no JAX (this module
imports it inside the functions that need it).  A case is a model's
reduced config (f32 activations and optimizer state) on a mesh in a mode:

* models: granite-3-2b (GQA, tied embeddings), deepseek-moe-16b (a dense
  prefix layer and an expert-parallel MoE layer), rwkv6-3b (K4 and K4b on
  the rank's heads) and jamba (Mamba on the rank's ``mamba_inner`` block,
  attention, expert-parallel MoE);
* modes: "tp" (Megatron), "tp+sp" (sequence parallel), "fsdp"
  (``sharding_mode="fsdp"``: ZeRO-3 over "model"), and for the MoE models
  "dedup" (``moe_dedup`` with ``moe_dest_k`` 1.5).

Each runs 2 steps from the reference's own ``init_params`` weights (padded
for the model axis, as the step pads the config) and one numpy batch, and
is held against the port's one-device step (``make_train_step(cfg,
None)``) on the same weights and batch: the losses, the ``grad_norm``s and
the gathered updated parameters, at 1e-5 relative (f32 sums taken in
another order; parameters also at atol 1e-5: the first AdamW steps move an
element by ``lr`` x sign(g) and the warm-up's ``lr`` is 3e-6).  For the MoE
models the one-device step's MoE is ``moe_ref`` on each rank's block of
tokens, its aux loss averaged over them: the expert-parallel paths' own
function (the reference's ``moe_ep`` averages the per-shard aux losses);
on the (4, 1) mesh the one-device step is the port's own, unchanged.  The
EP batches are small enough that no expert bucket can overflow (each rank
routes at most 2 tokens, under the capacities' floor of 4), so no token is
dropped and ``moe_ref`` is the EP paths' output.  granite and rwkv6 are
also held against the reference's unsharded step
(``repro.launch.steps.make_train_step(cfg, None, DistConfig())``, its
sharded step being red on this JAX: ROADMAP section 3, fault 5) at
``tests/test_torch_train.py``'s tolerances.

Then ``train`` on the (2, 2) mesh: 8 steps with a checkpoint every 3 and a
failure injected at step 5, restarted from step 3: the losses equal an
uninterrupted run's; a run restored at step 8 rewrites no checkpoint.  The ranks are joined under one time limit.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools
import multiprocessing
import os
import time

import numpy as np

from repro_torch.configs import registry as treg
from repro_torch.configs.base import pad_for_tp
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tM
from repro_torch.models.params import init_params, params_from_numpy, tree_leaves, tree_map

CPU = torch.device("cpu")
WORLD = 4
RANK_TIMEOUT_S = 240
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
MODES = {"tp": {}, "tp+sp": {"seq_parallel": True}, "fsdp": {"sharding_mode": "fsdp"},
         "dedup": {"moe_dedup": True, "moe_dest_k": 1.5}}
MODELS = {"granite": "granite_3_2b", "deepseek-moe": "deepseek_moe_16b", "rwkv6": "rwkv6_3b",
          "jamba": "jamba_1_5_large_398b"}
MOE = ("deepseek-moe", "jamba")
CASES = [(m, mesh, mode) for m in MODELS for mesh in MESHES for mode in MODES
         if (mode != "dedup" or m in MOE) and (mesh != "4x1" or mode == "tp")]
STEPS = 2
TOL = dict(rtol=1e-5, atol=1e-5)
# jamba's reduced hybrid (Mamba, attention and MoE layers; gradients of
# norm ~400) carries f32 noise of its own: its one-device step on the same
# batch with the two rows swapped moves the loss and grad_norm by 3.4e-6
# relative and the moments by 4.5e-5 of a leaf's largest.  Its metrics are
# held at 1e-4 (its family's tolerance in tests/test_torch_train.py) and
# its moments at 1e-3 of a leaf's largest; the other models' at 1e-5
HYBRID_TOL = (1e-4, 1e-3)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
RESTART = dict(steps=8, global_batch=4, seq_len=16, log_every=1, seed=0, device="cpu")
DATA = dict(seq_len=16, global_batch=8, vocab=97, seed=3)


def _cfg(model: str):
    return dataclasses.replace(treg.get_config(MODELS[model]).smoke(),
                               activation_dtype="float32", optstate_dtype="float32")


def _size(model: str, mesh: str) -> tuple[int, int]:
    """(B, S).  The MoE models route at most 2 tokens a rank (none can be
    dropped); the others 4 x 16."""
    if model in MOE:
        return {"2x2": (2, 4), "1x4": (1, 4), "4x1": (4, 4)}[mesh]
    return 4, 16


def _batch(model: str, mesh: str) -> dict:
    B, S = _size(model, mesh)
    rng = np.random.default_rng(1)
    cfg = _cfg(model)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :1] = -100
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32), "labels": labels}


def _tbatch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# each rank (no JAX here)
# ---------------------------------------------------------------------------

def _rank(rank: int, store: str, inputs_path: str, out_dir: str) -> None:
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.parallel.sharding import block, shard_tree, tree_shardings

    torch.distributed.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                         world_size=WORLD)
    try:
        torch.set_num_threads(1)
        inp = torch.load(inputs_path, weights_only=True)
        meshes = {name: make_mesh(shape, ("data", "model")) for name, shape in MESHES.items()}
        out = {}
        for model, mesh_name, mode in CASES:
            mesh = meshes[mesh_name]
            step, p_specs, o_specs, ctx = tsteps.make_train_step(
                _cfg(model), mesh, tsteps.DistConfig(**MODES[mode]))
            p_sh = tree_shardings(p_specs, mesh, ctx.rules)
            params = shard_tree(tree_map(torch.clone, inp[f"{model}/{mesh_name}/params"]), p_sh)
            o_sh = tree_shardings(o_specs, mesh, ctx.rules)
            opt = shard_tree(init_params(o_specs, torch.Generator().manual_seed(0)), o_sh)
            whole = inp[f"{model}/{mesh_name}/batch"]
            b_sh = tsteps.shardings_for_batch(whole, mesh, ctx.rules)
            batch = {k: block(v, b_sh[k].spec, mesh) for k, v in whole.items()}
            metrics = []
            for _ in range(STEPS):
                params, opt, m = step(params, opt, batch)
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
            out[f"{model}/{mesh_name}/{mode}"] = {
                "metrics": torch.tensor(metrics, dtype=torch.float64),
                "params": _gather_tree(params, p_sh), "step": int(opt["step"]),
                "moments": _gather_tree(opt["moments"], o_sh["moments"])}
        mesh = meshes["2x2"]
        cfg = _cfg("granite")
        it = batches(DataConfig(**DATA), tsteps.shardings_for_batch(
            {k: torch.empty(DATA["global_batch"], DATA["seq_len"]) for k in ("tokens", "labels")},
            mesh, tsteps.make_ctx(cfg, mesh, "train", tsteps.DistConfig()).rules),
            start_step=2, device="cpu")
        try:
            out["data/block"] = next(it)
        finally:
            it.close()
        ckpt = os.path.join(out_dir, "ckpt")
        _, _, want = train(cfg, mesh, **RESTART)
        try:
            train(cfg, mesh, ckpt_dir=ckpt, ckpt_every=3, fail_at=5, **RESTART)
            out["restart/raised"] = False
        except RuntimeError as e:
            out["restart/raised"] = "injected failure at step 5" in str(e)
        _, o, got = train(cfg, mesh, ckpt_dir=ckpt, ckpt_every=3, **RESTART)
        out["restart/want"] = torch.tensor(want, dtype=torch.float64)
        out["restart/got"] = torch.tensor(got, dtype=torch.float64)
        out["restart/step"] = int(o["step"])
        manifest = os.path.join(ckpt, f"step_{RESTART['steps']:08d}", "MANIFEST.json")
        written = os.stat(manifest).st_mtime_ns
        _, _, again = train(cfg, mesh, ckpt_dir=ckpt, ckpt_every=3, **RESTART)
        out["restart/again"] = torch.tensor(again, dtype=torch.float64)
        out["restart/rewritten"] = os.stat(manifest).st_mtime_ns != written
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "rank0.pt"))
        torch.save({k: v for k, v in out.items() if k.startswith(("restart/", "data/"))},
                   os.path.join(out_dir, f"restart{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _gather_tree(tree, shardings):
    """The whole tree from every rank's blocks, in fresh tensors."""
    from repro_torch.parallel.sharding import gather

    if isinstance(tree, dict):
        return {k: _gather_tree(tree[k], shardings[k]) for k in tree}
    with torch.no_grad():
        g = gather(tree, shardings.spec, shardings.mesh)
    return g.clone() if g is tree else g


def _run_ranks(tmp, inputs_path, meanwhile, target=None, timeout_s=RANK_TIMEOUT_S) -> None:
    """Start the 4 ranks (``target``, by default this module's ``_rank``,
    called as ``target(rank, store, inputs_path, out_dir)``), call
    ``meanwhile()``, join the ranks under one time limit and kill any
    left."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or _rank,
                         args=(r, str(tmp / "store"), str(inputs_path), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    meanwhile()
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung, f"{len(hung)} ranks still running after {timeout_s} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jparams(model: str, mesh: str) -> dict:
    """The reference's ``init_params`` of the config padded for the mesh's
    model axis, numpy."""
    import jax

    from repro.configs import registry as jreg
    from repro.configs.base import pad_for_tp as jpad
    from repro.models import transformer as jT
    from repro.models.params import init_params as jinit

    tp = MESHES[mesh][1]
    jcfg = jpad(dataclasses.replace(jreg.get_config(MODELS[model]).smoke(),
                                    activation_dtype="float32", optstate_dtype="float32"), tp)
    return jax.tree.map(np.asarray, jinit(jT.model_param_specs(jcfg, tp=tp),
                                          jax.random.PRNGKey(0)))


def _ep_oracle(dp: int, tp: int):
    """``moe_apply`` for the one-device step: ``moe_ref`` on each of the
    ``dp x tp`` blocks of tokens a rank routes (its batch rows, its slice
    of the sequence), the outputs put back in place and the aux losses
    averaged over "model" and then "data", as ``moe_ep`` averages them."""
    def apply(p, x, cfg, ctx, *, expert_perm=None):
        B, S, _ = x.shape
        rows = []
        aux_d = []
        for d in range(dp):
            cols, aux_m = [], []
            for m in range(tp):
                o, a = tM.moe_ref(p, x[d * B // dp:(d + 1) * B // dp,
                                       m * S // tp:(m + 1) * S // tp], cfg, ctx)
                cols.append(o)
                aux_m.append(a)
            rows.append(torch.cat(cols, 1))
            aux_d.append(torch.stack(aux_m).sum() / tp)
        return torch.cat(rows, 0), torch.stack(aux_d).sum() / dp
    return apply


@functools.lru_cache(maxsize=None)
def _one_device(model: str, mesh: str):
    """The port's one-device step, 2 steps: (metrics (2, 2), params,
    moments).  One for every mode: the modes lay the step out on a mesh."""
    cfg = pad_for_tp(_cfg(model), MESHES[mesh][1])
    step, _, o_specs, _ = tsteps.make_train_step(cfg, None, tsteps.DistConfig())
    params = params_from_numpy(_jparams(model, mesh), CPU)
    opt = init_params(o_specs, torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(model, mesh))
    saved = tM.moe_apply
    if model in MOE and MESHES[mesh][1] > 1:
        tM.moe_apply = _ep_oracle(*MESHES[mesh])
    try:
        metrics = []
        for _ in range(STEPS):
            params, opt, m = step(params, opt, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
    finally:
        tM.moe_apply = saved
    return np.array(metrics), params, opt["moments"]


def _reference(model: str, mesh: str):
    """The reference's unsharded step, 2 steps: (metrics (2, 2), params), of
    the config padded for the mesh's model axis."""
    padded = pad_for_tp(_cfg(model), MESHES[mesh][1]) != _cfg(model)
    return _reference_run(model, mesh if padded else "2x2" if _size(model, "2x2") ==
                          _size(model, mesh) else mesh)


@functools.lru_cache(maxsize=None)
def _reference_run(model: str, mesh: str):
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.configs.base import pad_for_tp as jpad
    from repro.launch import steps as jsteps
    from repro.models.params import init_params as jinit

    tp = MESHES[mesh][1]
    jcfg = jpad(dataclasses.replace(jreg.get_config(MODELS[model]).smoke(),
                                    activation_dtype="float32", optstate_dtype="float32"), tp)
    jstep, _, jos, _ = jsteps.make_train_step(jcfg, None, jsteps.DistConfig())
    params = _jparams(model, mesh)
    opt = jinit(jos, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(model, mesh).items()}
    step = jax.jit(jstep)
    metrics = []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    return np.array(metrics), params


# ---------------------------------------------------------------------------
# the run, once per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh")
    inputs = {}
    for model in MODELS:
        for mesh in MESHES:
            inputs[f"{model}/{mesh}/params"] = params_from_numpy(_jparams(model, mesh), CPU)
            inputs[f"{model}/{mesh}/batch"] = _tbatch(_batch(model, mesh))
    torch.save(inputs, tmp / "inputs.pt")

    def references():
        for model in MODELS:
            for mesh in MESHES:
                _one_device(model, mesh)
        for model in ("granite", "rwkv6"):
            for mesh in MESHES:
                _reference(model, mesh)

    _run_ranks(tmp, tmp / "inputs.pt", references)
    return {"rank0": torch.load(tmp / "rank0.pt", weights_only=True),
            "restart": [torch.load(tmp / f"restart{r}.pt", weights_only=True)
                        for r in range(WORLD)]}


@pytest.mark.parametrize("model,mesh,mode", CASES, ids=["-".join(c) for c in CASES])
def test_sharded_step_matches_the_one_device_step(ranks, model, mesh, mode):
    got = ranks["rank0"][f"{model}/{mesh}/{mode}"]
    want_metrics, want_params, want_moments = _one_device(model, mesh)
    rtol, moment_tol = HYBRID_TOL if model == "jamba" else (TOL["rtol"], TOL["rtol"])
    assert got["step"] == STEPS
    np.testing.assert_allclose(got["metrics"].numpy(), want_metrics, rtol=rtol)
    for g, w in zip(tree_leaves(got["params"]), tree_leaves(want_params)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    for g, w in zip(tree_leaves(got["moments"]), tree_leaves(want_moments)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=moment_tol,
                                   atol=moment_tol * w.abs().max().item())


@pytest.mark.parametrize("model", ["granite", "rwkv6"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_step_matches_the_reference_unsharded_step(ranks, model, mesh):
    """Every mode of the model on the mesh against the reference's unsharded
    step of the same (padded) config."""
    import jax

    want_metrics, want_params = _reference(model, mesh)
    for mode in [mode for m, mesh_, mode in CASES if (m, mesh_) == (model, mesh)]:
        got = ranks["rank0"][f"{model}/{mesh}/{mode}"]
        np.testing.assert_allclose(got["metrics"].numpy(), want_metrics, **REF_TOL)
        for g, w in zip(tree_leaves(got["params"]), jax.tree.leaves(want_params)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_restart_on_the_mesh_resumes(ranks):
    """``train`` on the (2, 2) mesh, a failure injected at step 5 and a
    restart from the step-3 checkpoint (each rank its own blocks): the
    losses of steps 4-8 equal the uninterrupted run's, on every rank.  A
    third run, restored at the last step, trains nothing and leaves that
    step's checkpoint as it was."""
    for r in ranks["restart"]:
        assert r["restart/raised"] and r["restart/step"] == RESTART["steps"]
        assert len(r["restart/again"]) == 0 and not r["restart/rewritten"]
        assert len(r["restart/got"]) == RESTART["steps"] - 3
        np.testing.assert_allclose(r["restart/got"].numpy(), r["restart/want"][3:].numpy(),
                                   rtol=1e-6, atol=0)
    assert all(torch.equal(r["restart/want"], ranks["restart"][0]["restart/want"])
               for r in ranks["restart"])


def test_each_rank_draws_its_own_block_of_the_batch(ranks):
    """On the (2, 2) mesh each rank draws its own data block of the batch,
    with no collective: ranks (d, 0) and (d, 1) both hold the B/2 rows at
    offset d B/2."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    src, B = SyntheticLM(DataConfig(**DATA)), DATA["global_batch"]
    for r, got in enumerate(ranks["restart"]):
        want = src.batch_at(2, B // 2, (r // 2) * B // 2)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got["data/block"][k].numpy(), want[k])
