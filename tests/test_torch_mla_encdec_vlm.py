"""The port's MLA, encoder-decoder and VLM paths, the MoE layers inside the
model and the unstacked prefix layers, against the JAX reference.

* ``mla_block`` and four steps of the absorbed-weight ``mla_decode_block``
  at 1e-4 (f32), at the reduced config's head dims and at minicpm3-4b's
  published ones (qk_nope 64 + qk_rope 32 = 96, v 64).
* K3 at the shapes this slice puts on the card: whisper's decode
  cross-attention (one query over 1500 encoder frames), its encoder
  (1500 x 1500, not causal) and MLA's head dim 96 over 40 heads.  What the
  CUDA wrapper hands the kernel (``prepare``) is fed to the plain version
  with the kernel's scale and held against ``repro.kernels.ref``.
* The reference's ``serve_smoke`` decodes the VLM ``n_patches`` positions
  past the prefill's end (ROADMAP section 3, fault 6); the port decodes
  where the prefill ended and matches the full forward.
* For the five new architectures: the decode step's replay contract (as
  ``tests/test_torch_decode.py`` holds it for granite and rwkv6), the
  decode graph's snapshot of exactly the buffers a step writes, no host
  read inside the step, the forward's MoE aux loss, the cache structure
  against the reference's ``cache_specs``, and ``make_batch``'s modality
  inputs.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jreg
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.launch.steps import DistConfig, make_ctx
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.models.params import init_params as jinit_params
from repro_torch.configs import registry as treg
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import SPLIT_MAX_SQ, prepare
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.layers import Ctx
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map
from test_torch_decode import EagerCapture, _host_read
from test_torch_models import (KEEP, _cfgs, _np_batch, _ref_params,
                               _reference_tokens, _to_torch)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
NEW = ["granite_moe_3b_a800m", "minicpm3_4b", "whisper_large_v3", "llava_next_mistral_7b",
       "deepseek_moe_16b"]
B, S, STEPS = 2, 12, 4


# -- MLA ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", ["reduced", "published"])
def test_mla_block_and_decode_match_the_reference(heads):
    extra = dict(activation_dtype="float32",
                 **(KEEP["minicpm3_4b"] if heads == "published" else {}))
    jcfg = dataclasses.replace(jreg.get_config("minicpm3_4b").smoke(), **extra)
    tcfg = dataclasses.replace(treg.get_config("minicpm3_4b").smoke(), **extra)
    jp = jinit_params(jL.mla_params(jcfg), jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jctx = make_ctx(jcfg, None, "prefill", DistConfig())
    ctx = Ctx(dtype=torch.float32)
    jout, (jlat, jkr) = jL.mla_block(jp, jnp.asarray(x), jcfg, jctx,
                                     positions=jnp.arange(S))
    with torch.inference_mode():
        tout, (tlat, tkr) = tL.mla_block(tp, torch.from_numpy(x), tcfg, ctx,
                                         positions=torch.arange(S))
    for got, want in ((tout, jout), (tlat, jlat), (tkr, jkr)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(tlat.shape) == (B, S, tcfg.kv_lora_rank)
    assert tuple(tkr.shape) == (B, S, tcfg.qk_rope_dim)

    jcache = {"latent": jnp.pad(jlat, ((0, 0), (0, STEPS), (0, 0))),
              "k_rope": jnp.pad(jkr, ((0, 0), (0, STEPS), (0, 0)))}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    dctx = make_ctx(jcfg, None, "decode", DistConfig(decode_seqpar=False))
    with torch.inference_mode():
        for i in range(STEPS):
            xt = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
            jo, jcache = jL.mla_decode_block(jp, jnp.asarray(xt), jcfg, dctx, cache=jcache,
                                             pos=S + i)
            buffers = [t.data_ptr() for t in tcache.values()]
            to, tcache = tL.mla_decode_block(tp, torch.from_numpy(xt), tcfg, ctx,
                                             cache=tcache, pos=torch.tensor([S + i]))
            assert [t.data_ptr() for t in tcache.values()] == buffers  # written in place
            assert tuple(to.shape) == (B, 1, tcfg.d_model)
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
            for name in ("latent", "k_rope"):
                np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                           **TOL)


# -- K3 at this slice's new shapes ----------------------------------------------------

K3_CASES = {  # B, H, K, Sq, Sk, hd, causal
    "whisper cross-attention in decode (Sq 1 over Sk 1500)": (2, 4, 4, 1, 1500, 64, False),
    "whisper encoder (1500 x 1500, full)": (1, 2, 2, 1500, 1500, 64, False),
    "minicpm3 MLA prefill (hd 96, 40 heads over 40)": (1, 40, 40, 48, 48, 96, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_prepare_at_the_new_shapes_feeds_the_plain_version_the_reference(case, dtype):
    """On the model's (B, S, heads, hd) views: the path (``fp32``; in bf16
    ``split`` for whisper's one query, ``tma`` otherwise, hd 96 built), then
    the plain version at the kernel's scale, cropped, against
    ``repro.kernels.ref`` (2e-5 in f32, 2e-2 in bf16)."""
    Bq, H, K, Sq, Sk, hd, causal = K3_CASES[case]
    rng = np.random.default_rng(hd + Sq)
    q, k, v = (rng.standard_normal((Bq, S_, n, hd)).astype(np.float32)
               for S_, n in ((Sq, H), (Sk, K), (Sk, K)))
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(dt).transpose(1, 2) for a in (q, k, v))
    path, pq, pk, pv = prepare(tq, tk, tv)
    assert path == ("fp32" if dtype == "float32" else "split" if Sq <= SPLIT_MAX_SQ else "tma")
    assert pq.shape[-1] == hd
    got = tref.flash_attention(pq, pk, pv, causal=causal, scale=1.0 / np.sqrt(hd))[..., :hd]
    assert tuple(got.shape) == (Bq, H, Sq, hd) and got.dtype == dt
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(dtype) for t in (tq, tk, tv))
    want = jref.flash_attention(jq, jk, jv, causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# -- the VLM's decode position ----------------------------------------------------------

def test_reference_serve_smoke_decodes_the_vlm_off_by_n_patches(monkeypatch):
    """Reduced llava in f32, 2 requests, a 24-position prompt (8 patches, 16
    text tokens).  ``make_batch`` already counts the patches in the prompt,
    so the prefill ends at 24; the reference's ``serve_smoke`` decodes at
    24 + 8, which leaves 8 zero K/V slots in the window decode attends to
    (scored 0, not masked).  Its first decode logits then differ from the
    full forward over the prompt and that token; the port's ``serve_smoke``
    decodes at 24 and matches the full forward at 1e-4."""
    jcfg, tcfg = _cfgs("llava_next_mistral_7b")
    n, P_ = 24, jcfg.n_patches
    jparams = _ref_params(jcfg)
    jbatch = jreg.make_batch(jcfg, n, B, train=False)
    assert jbatch["tokens"].shape == (B, n - P_) and jbatch["patch_embeds"].shape[1] == P_
    pctx = make_ctx(jcfg, None, "prefill", DistConfig())
    dctx = make_ctx(jcfg, None, "decode", DistConfig(decode_seqpar=False))
    cache, logits = jT.prefill(jparams, jbatch, jcfg, pctx, cache_len=n + 1 + P_)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    full_batch = dict(jbatch, tokens=jnp.concatenate([jbatch["tokens"], tok[:, None]], 1))
    _, full = jT.prefill(jparams, full_batch, jcfg, pctx)
    at_end, _ = jT.decode_step(jparams, cache, tok, jnp.int32(n), jcfg, dctx)
    off, _ = jT.decode_step(jparams, cache, tok, jnp.int32(n + P_), jcfg, dctx)
    full, at_end, off = (np.asarray(a) for a in (full, at_end, off))
    np.testing.assert_allclose(at_end, full, **TOL)
    assert np.abs(off - full).max() > 100 * TOL["atol"]

    seen = []
    decode_step = tT.decode_step

    def recording(params, cache, tok, pos, cfg, ctx):
        logits, cache = decode_step(params, cache, tok, pos, cfg, ctx)
        seen.append((pos, logits.clone()))
        return logits, cache

    monkeypatch.setattr(tserve.T, "decode_step", recording)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    tokens, _ = tserve.serve_smoke(tcfg, n_requests=B, prompt_len=n, decode_len=1,
                                   device="cpu", params=params, batch=_to_torch(jbatch))
    assert [pos for pos, _ in seen] == [n]
    np.testing.assert_array_equal(tokens[:, 0].numpy(), np.asarray(tok))
    np.testing.assert_allclose(seen[0][1].numpy(), full, **TOL)


# -- the five new architectures through the serving loop -----------------------------------

def _prefilled(arch):
    """Both packages prefilled from the reference's parameters and one batch:
    (jcfg, tcfg, jparams, tparams, jbatch, tcache, tlogits)."""
    jcfg, tcfg = _cfgs(arch)
    jparams = _ref_params(jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    jbatch = jreg.make_batch(jcfg, S, B, train=False)
    with torch.inference_mode():
        tcache, tlogits = tT.prefill(tparams, _to_torch(jbatch), tcfg,
                                     Ctx(dtype=torch.float32), cache_len=S + STEPS)
    return jcfg, tcfg, jparams, tparams, jbatch, tcache, tlogits


@pytest.mark.parametrize("arch", NEW)
def test_decode_graph_replay_contract_gives_reference_tokens(arch, monkeypatch):
    jcfg, tcfg, jparams, tparams, jbatch, cache, logits = _prefilled(arch)
    if jcfg.vlm:  # the reference's serve_smoke decodes the VLM off by n_patches
        want = _reference_tokens(jcfg, jparams, jbatch, STEPS)
    else:
        want, _ = jserve.serve_smoke(jcfg, n_requests=B, prompt_len=S, decode_len=STEPS,
                                     seed=0)
    monkeypatch.setattr(tserve, "CapturedChain", EagerCapture)
    ctx = Ctx(dtype=torch.float32)
    with torch.inference_mode():
        tok = logits.argmax(-1)
        buffers = [t.data_ptr() for t in tree_leaves(cache)]
        saved = tree_map(torch.clone, cache)
        graph = tserve.DecodeGraph(tparams, cache, tok, S, tcfg, ctx)
        # the warm-up's writes are undone: the cache is the prefill's again
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache), tree_leaves(saved)))
        out = [tok]
        for _ in range(STEPS):
            tok = graph(tok).argmax(-1)
            out.append(tok)
        graph.release()
    assert graph.chain.replays == STEPS
    assert [t.data_ptr() for t in tree_leaves(cache)] == buffers  # written in place
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", NEW)
def test_decode_graph_snapshots_exactly_the_buffers_decode_writes(arch):
    """``DecodeGraph`` snapshots and restores around its warm-up only the
    leaves ``_written_leaves`` names: every cache buffer one decode step
    changes, and none of the encoder's cross-attention K/V, which the step
    only reads."""
    _, tcfg, _, tparams, _, cache, logits = _prefilled(arch)

    def cross_leaves(tree):
        if not isinstance(tree, dict):
            return []
        return [leaf for k, v in tree.items()
                for leaf in (tree_leaves(v) if k == "cross" else cross_leaves(v))]

    with torch.inference_mode():
        before = tree_map(torch.clone, cache)
        tT.decode_step(tparams, cache, logits.argmax(-1), S, tcfg, Ctx(dtype=torch.float32))
    written = {id(t) for t in tserve._written_leaves(cache)}
    changed = {id(a) for a, b in zip(tree_leaves(cache), tree_leaves(before))
               if not torch.equal(a, b)}
    cross = {id(t) for t in cross_leaves(cache)}
    assert changed == written
    assert bool(cross) == tcfg.enc_dec and not cross & written
    assert len(written) + len(cross) == len(tree_leaves(cache))


@pytest.mark.parametrize("arch", NEW)
def test_decode_step_reads_no_device_value_on_the_host(arch, monkeypatch):
    _, tcfg, _, tparams, _, cache, logits = _prefilled(arch)
    ctx = Ctx(dtype=torch.float32)
    tok, pos = logits.argmax(-1), torch.tensor([S])
    with torch.inference_mode():
        want, _ = tT.decode_step(tparams, tree_map(torch.clone, cache), tok, S, tcfg, ctx)
        with monkeypatch.context() as mp:
            for name in ("item", "tolist", "__index__", "__int__", "__float__", "__bool__"):
                mp.setattr(torch.Tensor, name, _host_read)
            got, _ = tT.decode_step(tparams, cache, tok, pos, tcfg, ctx)
        assert torch.equal(got, want)
        meta = torch.device("meta")
        got, _ = tT.decode_step(tree_map(lambda t: t.to(meta), tparams),
                                tree_map(lambda t: t.to(meta), cache), tok.to(meta),
                                pos.to(meta), tcfg, ctx)
    assert got.device == meta and tuple(got.shape) == tuple(want.shape)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_moe_16b"])
def test_forward_aux_loss_matches_the_reference(arch):
    """The MoE layers' Switch aux losses summed over the prefix and the units."""
    jcfg, tcfg = _cfgs(arch)
    jparams = _ref_params(jcfg)
    batch = _np_batch(jcfg, B, S)
    _, _, jaux = jT.forward(jparams, jax.tree.map(jnp.asarray, batch), jcfg,
                            make_ctx(jcfg, None, "prefill", DistConfig()))
    with torch.inference_mode():
        _, _, taux = tT.forward(params_from_numpy(jax.tree.map(np.asarray, jparams), CPU),
                                _to_torch(batch), tcfg, Ctx(dtype=torch.float32))
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", NEW + ["granite_3_2b", "rwkv6_3b", "jamba_1_5_large_398b"])
def test_cache_specs_equal_the_reference(arch):
    """Shapes and dtypes of every decode cache leaf, in the reference's order:
    MLA's latent cache, the nested self/cross caches of the encoder-decoder,
    the prefix layers' unstacked caches, Mamba's f32 state and bf16 conv
    window."""
    jcfg, tcfg = _cfgs(arch)
    jspecs = jax.tree.leaves(jT.cache_specs(jcfg, 3, 20), is_leaf=lambda x: hasattr(x, "axes"))
    tspecs = tree_leaves(tT.cache_specs(tcfg, 3, 20))
    assert [s.shape for s in tspecs] == [s.shape for s in jspecs]
    assert [str(s.dtype).split(".")[-1] for s in tspecs] == [
        jnp.dtype(s.dtype).name for s in jspecs]


@pytest.mark.parametrize("arch", ["whisper_large_v3", "llava_next_mistral_7b"])
def test_make_batch_draws_the_modality_inputs(arch):
    cfg = treg.get_config(arch)
    a, b = (treg.make_batch(cfg, 600, 2, train=True, generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    jb = jreg.make_batch(jreg.get_config(arch), 600, 2, train=True)
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: v.shape for k, v in jb.items()}
    assert list(a) == list(jb)  # drawn in the reference's order
    name = "patch_embeds" if cfg.vlm else "enc_embeds"
    assert a[name].dtype == torch.bfloat16 and 0.015 < a[name].float().std() < 0.025
    assert a["tokens"].dtype == torch.int32
    assert all(torch.equal(a[k], b[k]) for k in a)
