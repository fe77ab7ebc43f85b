"""The port's training path (``models/transformer.py::lm_loss``,
``launch/steps.py``, ``launch/train.py``) against the JAX reference's
unsharded one, ``repro.launch.steps.make_train_step(cfg, None,
DistConfig())`` (its sharded step is red on this JAX: ROADMAP section 3,
fault 5).

The reduced configs of eight families (``hybrid`` is jamba's unit of Mamba
and attention layers: its loss and gradients go through the Mamba scan) and
of ``dense+softcap`` (granite with the attention and final logit caps at a
cut's values, ``repro_torch.configs.registry.CUT_VARIANTS``; at 2 x 32 positions the reference
differentiates its dense attention branch, whose capped gradient is right,
not its flash backward: ROADMAP section 3, fault 7), f32 activations, on
the reference's own ``init_params`` arrays carried across by
``params_from_numpy``, and one numpy batch of 2 x 32 positions (the VLM's
8 patch positions among them) with some labels masked at -100:

* ``lm_loss``, its CE and aux terms and the gradient of every parameter at
  1e-4 (f32, summed in another order);
* one train step: the updated parameters and moments at 1e-5 (the first
  AdamW step moves an element by about ``lr`` x sign(g), so an f32
  difference in a gradient barely shows), the loss and ``grad_norm`` at
  1e-4, the step counter;
* remat on against off, bit-equal on the CPU;
* train, crash at an injected step and restart from the checkpoint: the
  losses after the restart equal an uninterrupted run's at 1e-6 relative;
* what raises: the mesh-only fields and flags (ROADMAP queue 1, item 9),
  the card when CUDA is missing and the CPU was not asked for.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models.params import init_params as jinit
from repro.optim import adamw as jadamw
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tT
from repro_torch.models.params import params_from_numpy, tree_leaves

CPU = torch.device("cpu")
FAMILIES = {"dense": "granite_3_2b", "moe": "granite_moe_3b_a800m", "mla": "minicpm3_4b",
            "enc-dec": "whisper_large_v3", "vlm": "llava_next_mistral_7b",
            "prefix": "deepseek_moe_16b", "rwkv6": "rwkv6_3b",
            "hybrid": "jamba_1_5_large_398b", "dense+softcap": "granite_3_2b+softcap"}
B, S = 2, 32
TOL = dict(rtol=1e-4, atol=1e-4)


def _tol(family, want) -> dict:
    """1e-4; for the hybrid family atol 1e-4 x the largest value compared
    (``tests/test_torch_models.py::SCALED_ATOL`` says why)."""
    if family == "hybrid":
        return dict(rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    return TOL


def _cfgs(arch):
    """The reduced config with f32 activations and an f32 optimizer state
    (jamba's published bf16 state would round the first moments the
    gradients are read from); ``arch+variant`` with the variant's fields at a
    cut's values (``treg.split_variant(cut=True)``)."""
    arch, fields = treg.split_variant(arch, cut=True)
    extra = dict(activation_dtype="float32", optstate_dtype="float32", **fields)
    jcfg = dataclasses.replace(jreg.get_config(arch).smoke(), **extra)
    tcfg = dataclasses.replace(treg.get_config(arch).smoke(), **extra)
    return jcfg, tcfg


def _np_batch(cfg, seed=1):
    """S positions (the VLM's patches among them), f32 modality embeddings
    ``normal x 0.02``, int32 tokens and labels, the first three labels of
    row 0 masked."""
    rng = np.random.default_rng(seed)
    out, s = {}, S
    if cfg.vlm:
        out["patch_embeds"] = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                               * 0.02).astype(np.float32)
        s -= cfg.n_patches
    if cfg.enc_dec:
        out["enc_embeds"] = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
                             * 0.02).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    out["labels"][0, :3] = -100
    return out


@functools.lru_cache(maxsize=None)
def _reference(family):
    """One step of the reference's unsharded train step on the family's
    reduced config: (its config, the port's, the parameters, the optimizer
    state, the batch, the updated parameters and state, the metrics).  Both
    tests of a family read it, so the reference compiles once a family."""
    jcfg, tcfg = _cfgs(FAMILIES[family])
    jstep, jps, jos, _ = jsteps.make_train_step(jcfg, None, jsteps.DistConfig())
    params = jinit(jps, jax.random.PRNGKey(0))
    opt = jinit(jos, jax.random.PRNGKey(1))
    batch = _np_batch(jcfg)
    new_p, new_o, metrics = jstep(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    return jcfg, tcfg, params, opt, batch, new_p, new_o, metrics


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lm_loss_and_grads_match_reference(family):
    """The reference's loss terms are its step's metrics; its gradients are
    read from its step's first moments, which after one step from zero are
    ``(1 - b1) x clip x g`` with ``clip = min(1, 1 / grad_norm)`` (f32, a
    few roundings off the gradient ``jax.value_and_grad`` gave the step)."""
    jcfg, tcfg, params, _, batch, _, new_o, jm = _reference(family)
    jloss = jm["loss"]
    clip = np.minimum(np.float32(1.0), np.float32(1.0) / np.maximum(
        np.asarray(jm["grad_norm"], np.float32), np.float32(1e-9)))
    b1 = np.float32(1 - jadamw.AdamWConfig().b1)
    jgrads = [np.asarray(m) / b1 / clip for m in jax.tree.leaves(new_o["moments"])[0::2]]

    tp = params_from_numpy(params, CPU)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    ctx = tsteps.make_ctx(tcfg, "train", tsteps.DistConfig())
    loss, m = tT.lm_loss(tp, _tbatch(batch), tcfg, ctx)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for k in ("ce", "aux", "n_tok"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), **TOL)
    assert float(m["n_tok"]) == B * S - 3 - (jcfg.n_patches * B if jcfg.vlm else 0)
    want = jgrads
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **_tol(family, w))


@pytest.mark.parametrize("cap", sorted(treg.CUT_VARIANTS["softcap"]))
def test_each_softcap_moves_the_reduced_loss(cap):
    """Each cap of ``dense+softcap`` alone moves the loss of the reduced
    granite by more than twice the parity tolerance and its gradients by
    far more, so the parity tests would see either left out."""
    _, plain = _cfgs("granite_3_2b")
    capped = dataclasses.replace(plain, **{cap: treg.CUT_VARIANTS["softcap"][cap]})
    from repro_torch.models.params import init_params
    params = init_params(tT.model_param_specs(plain), torch.Generator().manual_seed(0))
    batch = _tbatch(_np_batch(plain))
    out = []
    for cfg in (plain, capped):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        tree = tsteps._rebuild(params, iter(leaves))
        loss, _ = tT.lm_loss(tree, batch, cfg, tsteps.make_ctx(cfg, "train",
                                                                tsteps.DistConfig()))
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (loss, grads), (capped_loss, capped_grads) = out
    assert abs(loss.item() - capped_loss.item()) > 2 * (TOL["atol"] + TOL["rtol"] * loss.item())
    assert max((a - b).abs().max().item() for a, b in zip(grads, capped_grads)) \
        > 100 * TOL["atol"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_reference(family):
    jcfg, tcfg, params, opt, batch, new_p, new_o, jm = _reference(family)
    step, p_specs, o_specs, ctx = tsteps.make_train_step(tcfg, tsteps.DistConfig())
    assert ctx.remat and ctx.dtype == torch.float32
    tp, to, tm = step(params_from_numpy(params, CPU), params_from_numpy(opt, CPU),
                      _tbatch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **TOL)
    assert int(to["step"]) == int(new_o["step"]) == 1
    for got, want in ((tp, new_p), (to["moments"], new_o["moments"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["granite_3_2b", "whisper_large_v3", "jamba_1_5_large_398b",
                                  "rwkv6_3b"])
def test_remat_on_and_off_are_bit_equal(arch):
    """Rematerializing each unit, encoder layer, Mamba chunk and CE chunk
    recomputes the same values: the loss and every gradient bit-equal on the
    CPU (rwkv6's through ``ops.WKV6`` and its plain backward)."""
    _, tcfg = _cfgs(arch)
    step, p_specs, _, _ = tsteps.make_train_step(tcfg)
    from repro_torch.models.params import init_params
    params = init_params(p_specs, torch.Generator().manual_seed(0))
    batch = _tbatch(_np_batch(tcfg))
    out = []
    for remat in (True, False):
        ctx = tsteps.make_ctx(tcfg, "train", tsteps.DistConfig(remat=remat))
        assert ctx.remat is remat
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        it = iter(leaves)
        tree = tsteps._rebuild(params, it)
        loss, _ = tT.lm_loss(tree, batch, tcfg, ctx)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_train_crash_and_restart_on_cpu(tmp_path):
    """12 steps, a checkpoint every 5, a failure injected before step 7: the
    rerun restores step 5, and its losses for steps 6..12 and its final
    parameters equal an uninterrupted run's at 1e-6 relative.  Not bit for
    bit: on the CPU the embedding's index backward (``index_put_`` with
    ``accumulate``) adds in parallel threads once it holds enough elements,
    in an order that changes from run to run."""
    _, cfg = _cfgs("granite_3_2b")
    kw = dict(steps=12, global_batch=2, seq_len=16, log_every=1, device="cpu")
    p_ref, _, want = ttrain.train(cfg, **kw)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        ttrain.train(cfg, ckpt_dir=ckpt, ckpt_every=5, fail_at=7, **kw)
    p, o, got = ttrain.train(cfg, ckpt_dir=ckpt, ckpt_every=5, **kw)
    assert int(o["step"]) == 12 and len(got) == 7
    np.testing.assert_allclose(got, want[5:], rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(p), tree_leaves(p_ref)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    ttrain.main(["--arch", "granite_3_2b", "--smoke", "--steps", "3", "--batch", "2",
                 "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                 "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "granite-3-2b-smoke" in out and "step     3 loss" in out
    assert sorted(d for d in (tmp_path).iterdir() if d.name.startswith("step_"))


@pytest.mark.parametrize("flag", ["--production-mesh", "--seq-parallel"])
def test_cli_mesh_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="item 9"):
        ttrain.main(["--smoke", "--device", "cpu", flag])


@pytest.mark.parametrize("field", [dict(sharding_mode="fsdp"), dict(seq_parallel=True),
                                   dict(moe_dedup=True), dict(moe_dest_k=1.5)])
def test_mesh_only_dist_fields_raise(field):
    _, cfg = _cfgs("granite_3_2b")
    with pytest.raises(NotImplementedError, match="item 9"):
        tsteps.make_train_step(cfg, tsteps.DistConfig(**field))


def test_train_asks_for_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("granite_3_2b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(cfg, steps=1, global_batch=2, seq_len=16)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        ttrain.main(["--smoke", "--steps", "1"])


def test_prefill_and_decode_steps_are_the_models():
    _, cfg = _cfgs("granite_3_2b")
    prefill, p_specs, _ = tsteps.make_prefill_step(cfg, cache_len=S + 2)
    decode, _, c_specs, ctx = tsteps.make_decode_step(cfg, tsteps.DistConfig(), B, S + 2)
    from repro_torch.models.params import init_params
    params = init_params(p_specs, torch.Generator().manual_seed(0))
    batch = {"tokens": _tbatch(_np_batch(cfg))["tokens"]}
    with torch.no_grad():
        cache, logits = prefill(params, batch)
        want_cache, want = tT.prefill(params, batch, cfg, ctx, cache_len=S + 2)
        assert torch.equal(logits, want)
        toks = logits.argmax(-1)
        got, _ = decode(params, cache, toks, S)
        ref, _ = tT.decode_step(params, want_cache, toks, S, cfg, ctx)
    assert torch.equal(got, ref)
    assert tree_leaves(c_specs)[0].shape[-3] == S + 2
