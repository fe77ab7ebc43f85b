"""The port's sharded serving steps (``launch/steps.py::make_prefill_step``
and ``make_decode_step`` on a mesh) over ``torch.distributed``: prefill
under ``TRAIN_RULES`` (Megatron heads and ``mlp`` over "model", the batch
over the data axes), its caches moved to decode's layout, then greedy
decode under ``DECODE_RULES`` (the same parameter blocks, each attention
cache's sequence over "model").

Four CPU processes, gloo, rendezvous through a ``file://`` store under
``tmp_path`` (``tests/test_torch_train_mesh.py``'s spawn helper), once for
the module: each rank builds a (data 2, model 2) mesh, a (data 1, model 4)
line and a (data 4, model 1) column, and runs every case on its blocks; the
tests below read what the ranks saved.  The rank processes import no JAX.
A case is a model's reduced config in f32 on a mesh:

* granite-3-2b (GQA; K3's plain version on the rank's heads), rwkv6-3b
  (K4's plain version on the rank's heads), deepseek-moe-16b (a dense
  prefix layer, the expert-parallel MoE in prefill and the rank's experts
  in decode), minicpm3-4b (MLA: its latent cache sequence-sharded in
  decode) and jamba (Mamba on the rank's channels, attention, MoE);
* a prefill of 8 positions into caches of 16, then 4 greedy decode steps
  (positions 8-11: the first of the (1, 4) line's third shard, and on
  across it); and for granite the caches split by heads in decode, without
  ``decode_seqpar`` and with a cache of 17 the model axis does not divide.

Each runs from the reference's own ``init_params`` weights of the config
padded for the model axis (as the steps pad it), cut into the rank's
blocks, and is held against the port's one-device steps on the whole
weights: the prefill's and every step's logits at 1e-5 in f32 (jamba at
1e-4, its own noise: :data:`HYBRID_TOL`), the greedy tokens equal, and the
rank's blocks of the caches after the last step.
The EP batches are small enough that no expert bucket can overflow (each
rank routes at most 4 tokens, the capacities' floor), so no token is
dropped and ``moe_ref`` is the EP paths' output.  granite and rwkv6 are
also held against the reference's unsharded ``prefill`` + ``decode_step``
at 1e-4, the suite's serving tolerance (its sharded steps are red on this
JAX: ROADMAP section 3, fault 5).
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools
import os

import numpy as np

from repro_torch.configs import registry as treg
from repro_torch.configs.base import pad_for_tp
from repro_torch.launch import steps as tsteps
from repro_torch.models.params import params_from_numpy, tree_leaves
from test_torch_train_mesh import _run_ranks

CPU = torch.device("cpu")
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
MODELS = {"granite": "granite_3_2b", "rwkv6": "rwkv6_3b", "deepseek-moe": "deepseek_moe_16b",
          "minicpm3": "minicpm3_4b", "jamba": "jamba_1_5_large_398b"}
S, CACHE, STEPS = 8, 16, 4
# the caches' layouts in decode: "seqpar" each attention cache's sequence
# over "model" (the default); "heads" without decode_seqpar, the caches
# split by heads; "odd-cache" a cache of 17, which the model axis does not
# divide, so they split by heads too
VARIANTS = {"seqpar": ({}, CACHE), "heads": ({"decode_seqpar": False}, CACHE),
            "odd-cache": ({}, 17)}
CASES = [(m, mesh, "seqpar") for m in MODELS for mesh in MESHES] + \
    [("granite", "1x4", "heads"), ("granite", "2x2", "odd-cache")]
TOL = dict(rtol=1e-5, atol=1e-5)
# jamba's reduced hybrid carries f32 noise of its own: its one-device steps
# on the (2, 2) mesh's two prompts at once and on each alone differ by up to
# 6.7e-5 in the logits (of |logit| <= 4.3), the other models' by <= 2.7e-6.
# It is held at its family's tolerance in tests/test_torch_models.py, 1e-4
HYBRID_TOL = dict(rtol=1e-4, atol=1e-4)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
RANK_TIMEOUT_S = 180


def _cfg(model: str):
    """The reduced config in f32: one unit of jamba's eight layers,
    deepseek's dense prefix layer and two units of the others."""
    cfg = treg.get_config(MODELS[model]).smoke()
    n = cfg.n_layers if len(cfg.unit) > 1 else len(cfg.prefix) + 2
    return dataclasses.replace(cfg, n_layers=n, activation_dtype="float32")


def _batch(mesh: str) -> np.ndarray:
    """Prompts: 2 on the (2, 2) mesh and the (1, 4) line (each rank routes
    1 x 4 or 2 x 2 tokens through the EP MoE), 4 on the (4, 1) column."""
    B = 4 if mesh == "4x1" else 2
    return np.random.default_rng(5).integers(0, 512, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# each rank (no JAX here)
# ---------------------------------------------------------------------------

def _serve(prefill, decode, params, cache_params, tokens, vocab):
    """Prefill, then ``STEPS`` greedy steps: (logits (1 + STEPS, B, V), cache)."""
    with torch.inference_mode():
        cache, logits = prefill(params, {"tokens": tokens})
        out = [logits]
        for i in range(STEPS):
            logits, cache = decode(cache_params, cache, logits[:, :vocab].argmax(-1), S + i)
            out.append(logits)
    return torch.stack(out), cache


def _rank(rank: int, store: str, inputs_path: str, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import block, shard_tree, tree_shardings

    torch.distributed.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                         world_size=4)
    try:
        torch.set_num_threads(1)
        inp = torch.load(inputs_path, weights_only=True)
        meshes = {name: make_mesh(shape, ("data", "model")) for name, shape in MESHES.items()}
        out = {}
        for model, mesh_name, variant in CASES:
            mesh, cfg = meshes[mesh_name], _cfg(model)
            whole = inp[f"{model}/{mesh_name}"]
            tokens = inp[f"batch/{mesh_name}"]
            fields, cache_len = VARIANTS[variant]
            dist = tsteps.DistConfig(**fields)
            prefill, p_specs, pctx = tsteps.make_prefill_step(cfg, mesh, dist, cache_len)
            decode, d_specs, c_specs, dctx = tsteps.make_decode_step(
                cfg, mesh, dist, tokens.shape[0], cache_len)
            p_sh = tree_shardings(p_specs, mesh, pctx.rules)
            params = shard_tree(whole, p_sh)
            # one parameter layout: decode reads the prefill's blocks
            assert ([s.spec for s in tree_leaves(p_sh)] ==
                    [s.spec for s in tree_leaves(tree_shardings(d_specs, mesh, dctx.rules))])
            b_sh = tsteps.shardings_for_batch({"tokens": tokens}, mesh, pctx.rules)
            logits, cache = _serve(prefill, decode, params, params,
                                   block(tokens, b_sh["tokens"].spec, mesh), cfg.vocab)
            c_sh = tree_shardings(c_specs, mesh, dctx.rules)
            shapes = [tuple(block(torch.empty(s.shape, device="meta"), sh.spec, mesh).shape)
                      for s, sh in zip(tree_leaves(c_specs), tree_leaves(c_sh))]
            assert [tuple(c.shape) for c in tree_leaves(cache)] == shapes, model
            out[f"{model}/{mesh_name}/{variant}"] = {"logits": logits, "cache": cache,
                                                     "seqpar": dctx.seq_sharded_cache}
        out["axes"] = torch.tensor([[m.axis_index(a) for a in ("data", "model")]
                                    for m in meshes.values()])
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jparams(model: str, tp: int) -> dict:
    """The reference's ``init_params`` of the config padded for ``tp``, numpy."""
    import jax

    from repro.configs.base import pad_for_tp as jpad
    from repro.models import transformer as jT
    from repro.models.params import init_params as jinit

    jcfg = jpad(_jcfg(model), tp)
    return jax.tree.map(np.asarray, jinit(jT.model_param_specs(jcfg, tp=tp),
                                          jax.random.PRNGKey(0)))


def _jcfg(model: str):
    from repro.configs import registry as jreg

    cfg = jreg.get_config(MODELS[model]).smoke()
    n = cfg.n_layers if len(cfg.unit) > 1 else len(cfg.prefix) + 2
    return dataclasses.replace(cfg, n_layers=n, activation_dtype="float32")


@functools.lru_cache(maxsize=None)
def _one_device(model: str, mesh: str, cache_len: int = CACHE):
    """The port's one-device steps on the whole weights of the padded config:
    (logits (1 + STEPS, B, V), cache)."""
    tp = MESHES[mesh][1]
    tokens = torch.from_numpy(_batch(mesh))
    cfg = pad_for_tp(_cfg(model), tp)
    prefill, _, _ = tsteps.make_prefill_step(cfg, None, cache_len=cache_len)
    decode, _, _, _ = tsteps.make_decode_step(cfg, None, tsteps.DistConfig(), tokens.shape[0],
                                              cache_len)
    params = params_from_numpy(_jparams(model, tp), CPU)
    return _serve(prefill, decode, params, params, tokens, cfg.vocab)


@functools.lru_cache(maxsize=None)
def _reference(model: str, mesh: str) -> np.ndarray:
    """The reference's unsharded prefill + ``decode_step`` of the padded
    config, greedy: logits (1 + STEPS, B, V)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import pad_for_tp as jpad
    from repro.launch.steps import DistConfig, make_ctx
    from repro.models import transformer as jT

    tp = MESHES[mesh][1]
    jcfg = jpad(_jcfg(model), tp)
    params = _jparams(model, tp)
    pctx = make_ctx(jcfg, None, "prefill", DistConfig())
    dctx = make_ctx(jcfg, None, "decode", DistConfig(decode_seqpar=False))
    cache, logits = jax.jit(lambda p, t: jT.prefill(p, {"tokens": t}, jcfg, pctx,
                                                    cache_len=CACHE))(params, _batch(mesh))
    step = jax.jit(lambda p, c, t, i: jT.decode_step(p, c, t, i, jcfg, dctx))
    out = [np.asarray(logits)]
    for i in range(STEPS):
        logits, cache = step(params, cache,
                             jnp.argmax(logits[:, :jcfg.vocab], -1).astype(jnp.int32),
                             jnp.int32(S + i))
        out.append(np.asarray(logits))
    return np.stack(out)


# ---------------------------------------------------------------------------
# the run, once per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    inputs = {f"{model}/{mesh}": params_from_numpy(_jparams(model, MESHES[mesh][1]), CPU)
              for model, mesh, _ in CASES}
    inputs.update({f"batch/{mesh}": torch.from_numpy(_batch(mesh)) for mesh in MESHES})
    torch.save(inputs, tmp / "inputs.pt")

    def references():
        for model, mesh, variant in CASES:
            _one_device(model, mesh, VARIANTS[variant][1])
        for model in ("granite", "rwkv6"):
            for mesh in MESHES:
                _reference(model, mesh)

    _run_ranks(tmp, tmp / "inputs.pt", references, target=_rank, timeout_s=RANK_TIMEOUT_S)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(4)]


def _data_block(ranks, r: int, mesh: str, B: int) -> slice:
    """Rank r's rows of a batch of B on ``mesh`` (all of them where the
    data axis does not divide B)."""
    dp = MESHES[mesh][0]
    d = int(ranks[r]["axes"][list(MESHES).index(mesh)][0])
    n = B // dp if B % dp == 0 else B
    return slice(d * n, (d + 1) * n) if B % dp == 0 else slice(0, B)


def _cache_block(ranks, r: int, mesh: str, want, got, rows: slice):
    """The rank's block of a whole one-device cache leaf ``want`` (stacked
    units first, then the batch) that has ``got``'s shape: its rows, then,
    along the one dimension that differs, its coordinate's slice over
    "model"."""
    m = int(ranks[r]["axes"][list(MESHES).index(mesh)][1])
    want = want[:, rows]
    for dim, (n_w, n_g) in enumerate(zip(want.shape, got.shape)):
        if n_w != n_g:
            want = want.narrow(dim, m * n_g, n_g)
    return want


def _cache_leaves(cache) -> list:
    """The cache's leaves, each with the stacked units' dimension first (a
    prefix layer's gets one of 1)."""
    return [leaf if part == "unit" else leaf[None]
            for part in sorted(cache) for leaf in tree_leaves(cache[part])]


@pytest.mark.parametrize("model,mesh,variant", CASES,
                         ids=["-".join(c[:2] if c[2] == "seqpar" else c) for c in CASES])
def test_sharded_serving_matches_the_one_device_steps(ranks, model, mesh, variant):
    """Every rank's logits (its data block, the whole padded vocabulary) of
    the prefill and of 4 greedy steps at 1e-5, the greedy tokens equal, and
    its blocks of the caches after the last step; on a model axis above 1
    the attention caches are sequence-sharded but for the two variants."""
    want, want_cache = _one_device(model, mesh, VARIANTS[variant][1])
    vocab = _cfg(model).vocab
    tol = HYBRID_TOL if model == "jamba" else TOL
    B = want.shape[1]
    for r, res in enumerate(ranks):
        got = res[f"{model}/{mesh}/{variant}"]
        rows = _data_block(ranks, r, mesh, B)
        np.testing.assert_allclose(got["logits"].numpy(), want[:, rows].numpy(), **tol)
        np.testing.assert_array_equal(got["logits"][..., :vocab].argmax(-1).numpy(),
                                      want[:, rows, :vocab].argmax(-1).numpy())
        for g, w in zip(_cache_leaves(got["cache"]), _cache_leaves(want_cache)):
            np.testing.assert_allclose(g.numpy(), _cache_block(ranks, r, mesh, w, g, rows)
                                       .numpy(), **tol)
        assert got["seqpar"] == (MESHES[mesh][1] > 1 and variant == "seqpar")


@pytest.mark.parametrize("model", ["granite", "rwkv6"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_serving_matches_the_reference_unsharded_steps(ranks, model, mesh):
    """The same logits against the reference's unsharded prefill +
    ``decode_step`` of the padded config at 1e-4, the greedy tokens equal."""
    want = _reference(model, mesh)
    vocab = _cfg(model).vocab
    for r, res in enumerate(ranks):
        got = res[f"{model}/{mesh}/seqpar"]["logits"].numpy()
        rows = _data_block(ranks, r, mesh, want.shape[1])
        np.testing.assert_allclose(got, want[:, rows], **REF_TOL)
        np.testing.assert_array_equal(got[..., :vocab].argmax(-1),
                                      want[:, rows, :vocab].argmax(-1))
