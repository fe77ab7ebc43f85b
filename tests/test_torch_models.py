"""The port's model serving path (configs, params, transformer, serve_smoke)
against the JAX reference, for the architectures the port serves.

``granite_3_2b`` (dense GQA attention, K3), ``rwkv6_3b`` (RWKV-6, K4),
``minitron_4b`` (dense GQA attention at its head_dim of 128, set on both
packages' reduced configs), ``granite_moe_3b_a800m`` (MoE), ``minicpm3_4b``
(MLA, kept at its published head dims: qk_nope 64 + qk_rope 32 = 96, v 64),
``whisper_large_v3`` (encoder-decoder), ``llava_next_mistral_7b`` (VLM),
``deepseek_moe_16b`` (a dense prefix layer, then MoE with shared experts),
``jamba_1_5_large_398b`` (one 8-layer hybrid unit: Mamba, attention at index
4, MoE every other layer), ``command_r_35b`` (dense GQA, rope theta 8e6)
and ``granite_3_2b+softcap`` (granite with an attention logit cap and a
final logit cap, the pair Gemma 2 sets, at the values that bite at the
reduced widths: ``repro_torch.configs.registry.CUT_VARIANTS``) run in
their reduced configs with f32 activations, on the reference's own
``init_params`` arrays carried across by ``params_from_numpy``.  Prefill
logits and caches and four decode steps agree at 1e-4 (f32, summed in
another order); greedy tokens are equal.  The MoE routers see f32 inputs
drawn from a seed, on which no two routing probabilities tie, so
``torch.topk`` and ``jax.lax.top_k`` pick the same experts.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.launch.steps import DistConfig, make_ctx
from repro.models import transformer as jT
from repro.models.params import init_params as jinit_params
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tT
from repro_torch.models.layers import Ctx
from repro_torch.models.params import (cast_params, init_params, params_from_numpy,
                                       tree_leaves)

CPU = torch.device("cpu")
ARCHS = ["granite_3_2b", "rwkv6_3b", "minitron_4b", "granite_moe_3b_a800m", "minicpm3_4b",
         "whisper_large_v3", "llava_next_mistral_7b", "deepseek_moe_16b",
         "jamba_1_5_large_398b", "command_r_35b", "granite_3_2b+softcap"]
# fields the reduced config resets that a served head dim depends on
KEEP = {"minitron_4b": dict(head_dim=128),
        "minicpm3_4b": dict(head_dim=96, qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64)}
TOL = dict(rtol=1e-4, atol=1e-4)
# jamba's unit at the reference's init carries its residual stream and Mamba
# states at 10-20 (the skip D = 1 beside an undamped A = -1 state), and eight
# layers carry each one's f32 rounding forward: each layer's own error
# against a float64 run is the same size in both packages, yet the sum sits
# above an elementwise atol of 1e-4 on small entries of large tensors.  Its
# atol is 1e-4 x the largest value compared, as [card-vs-cpu]'s.
SCALED_ATOL = {"jamba_1_5_large_398b"}
B, S, STEPS = 2, 12, 4


def _tol(arch, want) -> dict:
    if arch in SCALED_ATOL:
        return dict(rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    return TOL


def _cfgs(arch):
    """Both packages' reduced configs of ``arch`` (``arch+variant``: with the
    variant's fields at a cut's values, ``treg.split_variant(cut=True)``),
    f32 activations."""
    arch, fields = treg.split_variant(arch, cut=True)
    extra = dict(activation_dtype="float32", **KEEP.get(arch, {}), **fields)
    jcfg = dataclasses.replace(jreg.get_config(arch).smoke(), **extra)
    tcfg = dataclasses.replace(treg.get_config(arch).smoke(), **extra)
    return jcfg, tcfg


def _ref_params(jcfg, seed=0):
    return jinit_params(jT.model_param_specs(jcfg, tp=1), jax.random.PRNGKey(seed))


def _np_batch(cfg, b, s, seed=1):
    """A numpy batch of ``s`` positions: int32 tokens, and the VLM's patch
    embeddings (which take ``n_patches`` of the positions) or the encoder's
    frames, f32 ``normal x 0.02``."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.vlm:
        out["patch_embeds"] = (rng.standard_normal((b, cfg.n_patches, cfg.d_model))
                               * 0.02).astype(np.float32)
        s -= cfg.n_patches
    if cfg.enc_dec:
        out["enc_embeds"] = (rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
                             * 0.02).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def _to_torch(batch):
    """A reference (or numpy) batch as CPU tensors, bf16 kept bit for bit."""
    return params_from_numpy(jax.tree.map(np.asarray, dict(batch)), CPU)


def _reference_tokens(jcfg, jparams, jbatch, decode_len):
    """Greedy tokens of the reference's prefill and ``decode_step``, decoding
    from where the prefill's sequence ended (the reference's own
    ``serve_smoke`` starts the VLM ``n_patches`` later: ROADMAP section 3,
    fault 6)."""
    S = jbatch["tokens"].shape[1] + (jcfg.n_patches if jcfg.vlm else 0)
    pctx = make_ctx(jcfg, None, "prefill", DistConfig())
    dctx = make_ctx(jcfg, None, "decode", DistConfig(decode_seqpar=False))
    cache, logits = jT.prefill(jparams, jbatch, jcfg, pctx, cache_len=S + decode_len)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [tok]
    for i in range(decode_len):
        logits, cache = jT.decode_step(jparams, cache, tok, jnp.int32(S + i), jcfg, dctx)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(tok)
    return np.stack([np.asarray(t) for t in out], 1)


def _np_leaves(tree):
    """Leaves in sorted-key order as numpy (works on both packages' trees)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.float().numpy().copy()]
    return [np.asarray(tree, np.float32)]


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_copied_configs_equal_the_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.smoke()) == dataclasses.asdict(jcfg.smoke())
    assert tcfg.padded_vocab(1) == jcfg.padded_vocab(1)
    assert treg.ARCH_IDS == jreg.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jspecs = jT.model_param_specs(jcfg, tp=1)
    tspecs = tT.model_param_specs(tcfg)
    jshapes = [s.shape for s in jax.tree.leaves(jspecs, is_leaf=lambda x: hasattr(x, "axes"))]
    assert [s.shape for s in tree_leaves(tspecs)] == jshapes
    params = init_params(tspecs, torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in tree_leaves(params)] == jshapes
    again = init_params(tspecs, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams = _ref_params(jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    batch = _np_batch(jcfg, B, S)
    pctx = make_ctx(jcfg, None, "prefill", DistConfig())
    dctx = make_ctx(jcfg, None, "decode", DistConfig(decode_seqpar=False))
    tctx = Ctx(dtype=torch.float32)

    jcache, jlogits = jT.prefill(jparams, jax.tree.map(jnp.asarray, batch), jcfg, pctx,
                                 cache_len=S + STEPS)
    with torch.inference_mode():
        tcache, tlogits = tT.prefill(tparams, _to_torch(batch), tcfg, tctx,
                                     cache_len=S + STEPS)
    assert tuple(tlogits.shape) == (B, tcfg.padded_vocab(1))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **_tol(arch, jlogits))
    jl, tl = _np_leaves(jcache), _np_leaves(tcache)
    assert [x.shape for x in tl] == [x.shape for x in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **_tol(arch, b))

    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    assert np.array_equal(tlogits.argmax(-1).numpy(), tok)
    with torch.inference_mode():
        for i in range(STEPS):
            jlogits, jcache = jT.decode_step(jparams, jcache, jnp.asarray(tok),
                                             jnp.int32(S + i), jcfg, dctx)
            tlogits, tcache = tT.decode_step(tparams, tcache, torch.from_numpy(tok),
                                             S + i, tcfg, tctx)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **_tol(arch, jlogits))
            tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
            assert np.array_equal(tlogits.argmax(-1).numpy(), tok)
    for a, b in zip(_np_leaves(tcache), _np_leaves(jcache)):
        np.testing.assert_allclose(a, b, **_tol(arch, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_tokens_equal_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    # the reference's serve_smoke draws these two from seed 0 and PRNGKey(0)
    jparams = _ref_params(jcfg)
    batch = jreg.make_batch(jcfg, S, B, train=False)
    if jcfg.vlm:  # the reference's serve_smoke decodes the VLM off by n_patches
        want = _reference_tokens(jcfg, jparams, batch, STEPS)
    else:
        want, _ = jserve.serve_smoke(jcfg, n_requests=B, prompt_len=S, decode_len=STEPS,
                                     seed=0)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    tokens, stats = tserve.serve_smoke(
        tcfg, n_requests=B, prompt_len=S, decode_len=STEPS, device="cpu", params=params,
        batch=_to_torch(batch))
    assert tokens.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
    assert stats.logits_finite and stats.prefill_ms > 0 and stats.tokens_per_s > 0


def test_serve_smoke_runs_from_its_own_seed_and_needs_cuda_by_default():
    _, tcfg = _cfgs("rwkv6_3b")
    a, _ = tserve.serve_smoke(tcfg, n_requests=2, prompt_len=5, decode_len=2, device="cpu")
    b, _ = tserve.serve_smoke(tcfg, n_requests=2, prompt_len=5, decode_len=2, device="cpu")
    assert torch.equal(a, b) and a.shape == (2, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.serve_smoke(tcfg, n_requests=1, prompt_len=2, decode_len=1)
        with pytest.raises(SystemExit):
            tserve.main(["--smoke", "--arch", "rwkv6_3b"])


def test_make_batch_draws_from_the_generator():
    _, tcfg = _cfgs("granite_3_2b")
    a = treg.make_batch(tcfg, 7, 3, train=True, generator=torch.Generator().manual_seed(4))
    b = treg.make_batch(tcfg, 7, 3, train=True, generator=torch.Generator().manual_seed(4))
    assert set(a) == {"tokens", "labels"} and a["tokens"].shape == (3, 7)
    assert a["tokens"].dtype == torch.int32
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < tcfg.vocab
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_prefill_caches(arch):
    _, tcfg = _cfgs(arch)
    params = init_params(tT.model_param_specs(tcfg), torch.Generator().manual_seed(0))
    S0 = 6 + (tcfg.n_patches if tcfg.vlm else 0)
    with torch.inference_mode():
        cache, _ = tT.prefill(params, _to_torch(_np_batch(tcfg, 2, S0)), tcfg,
                              Ctx(dtype=torch.float32), cache_len=S0 + 3)
    specs = tT.cache_specs(tcfg, 2, S0 + 3)
    assert [s.shape for s in tree_leaves(specs)] == [tuple(t.shape) for t in
                                                       tree_leaves(cache)]


def test_cast_params_keeps_the_f32_parameters():
    _, tcfg = _cfgs("rwkv6_3b")
    params = init_params(tT.model_param_specs(tcfg), torch.Generator().manual_seed(0))
    cast = cast_params(params, torch.bfloat16)
    mixer = cast["unit"]["l0"]["mixer"]
    assert mixer["wr"].dtype == torch.bfloat16 and cast["embed"].dtype == torch.bfloat16
    for name in ("w0", "w_b", "u", "ln_out_scale", "ln_out_bias"):
        assert mixer[name].dtype == torch.float32
    assert cast["final_norm"]["scale"].dtype == torch.float32
    assert torch.equal(mixer["wr"], params["unit"]["l0"]["mixer"]["wr"].to(torch.bfloat16))


def test_the_attention_cap_moves_the_reduced_logits():
    """``+softcap``'s attention cap bites at the reduced widths: the prefill
    and decode logits differ from the uncapped model's by far more than the
    parity tolerance, so the parity tests above would see it left out.  The
    final logit cap leaves the served logits as they are: the reference
    applies it in the training loss alone (``tests/test_torch_train.py``)."""
    _, plain = _cfgs("granite_3_2b")
    _, capped = _cfgs("granite_3_2b+softcap")
    final_only = dataclasses.replace(plain, logits_softcap=capped.logits_softcap)
    params = init_params(tT.model_param_specs(plain), torch.Generator().manual_seed(0))
    batch = _to_torch(_np_batch(plain, B, S))
    ctx = Ctx(dtype=torch.float32)
    out = {}
    with torch.inference_mode():
        for name, c in (("plain", plain), ("capped", capped), ("final only", final_only)):
            cache, logits = tT.prefill(params, batch, c, ctx, cache_len=S + 1)
            step, _ = tT.decode_step(params, cache, torch.zeros(B, dtype=torch.int32), S, c,
                                     ctx)
            out[name] = (logits, step)
    for a, b in zip(out["plain"], out["capped"]):
        assert (a - b).abs().max().item() > 100 * TOL["atol"]
    for a, b in zip(out["plain"], out["final only"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_in_the_served_dtype_equals_the_cast_tree(arch):
    """``init_params`` with a dtype casts each leaf as it is drawn: the same
    bits as casting the f32 tree afterwards, the f32 parameters kept."""
    _, tcfg = _cfgs(arch)
    specs = tT.model_param_specs(tcfg)
    got = init_params(specs, torch.Generator().manual_seed(0), torch.bfloat16)
    want = cast_params(init_params(specs, torch.Generator().manual_seed(0)), torch.bfloat16)
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    assert {t.dtype for t in got} <= {torch.bfloat16, torch.float32}
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
