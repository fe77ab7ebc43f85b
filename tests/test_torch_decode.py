"""The port's decode step with its position as a device tensor, and the
captured-step contract that ``launch/serve.py``'s ``DecodeGraph`` relies on,
against the JAX reference.

* ``decode_step`` with a one-element ``long`` position is bit-equal to the
  ``int`` call and matches the reference's ``decode_step`` (a traced int32
  position) at 1e-4 in f32, for an ``attn`` and an ``rwkv6`` architecture
  and the ``attn`` one with an attention logit cap.
* The replay contract: ``DecodeGraph`` with its capture replaced by a
  stand-in that calls the one captured closure over fixed token, position
  and cache buffers, rewritten in place (the card's CUDA graph does the
  same with the kernels it recorded), gives the reference ``serve_smoke``'s
  greedy tokens.  The stand-in executes the warm-up as the card does, so a
  cache not restored after it would advance every RWKV state one token.
* Nothing in the step reads the position, or any other device value, on the
  host: with ``Tensor.item`` and the Python number conversions patched to
  raise, and on the ``meta`` device, where every host read raises.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch import serve as jserve
from repro.launch.steps import DistConfig, make_ctx
from repro.models import transformer as jT
from repro.configs import registry as jreg
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tT
from repro_torch.models.layers import Ctx
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map
from test_torch_models import _cfgs, _np_leaves, _ref_params

CPU = torch.device("cpu")
# one attn, one rwkv6 architecture, and the attn one with its logit caps (the
# decode graph bakes the attention cap in as a Python float)
ARCHS = ["granite_3_2b", "rwkv6_3b", "granite_3_2b+softcap"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS = 2, 12, 4


def _prefilled(arch):
    """Both packages prefilled from the reference's parameters and one token
    draw: (jcfg, tcfg, jparams, tparams, jcache, jlogits, tcache, tlogits)."""
    jcfg, tcfg = _cfgs(arch)
    jparams = _ref_params(jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    pctx = make_ctx(jcfg, None, "prefill", DistConfig())
    jcache, jlogits = jT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, pctx,
                                 cache_len=S + STEPS)
    with torch.inference_mode():
        tcache, tlogits = tT.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                                     Ctx(dtype=torch.float32), cache_len=S + STEPS)
    return jcfg, tcfg, jparams, tparams, jcache, jlogits, tcache, tlogits


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_is_bit_equal_to_int_and_matches_reference(arch):
    jcfg, tcfg, jparams, tparams, jcache, jlogits, cache_int, _ = _prefilled(arch)
    dctx = make_ctx(jcfg, None, "decode", DistConfig(decode_seqpar=False))
    ctx = Ctx(dtype=torch.float32)
    cache_t = tree_map(torch.clone, cache_int)
    pos = torch.tensor([S])
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    with torch.inference_mode():
        for i in range(STEPS):
            jlogits, jcache = jT.decode_step(jparams, jcache, jnp.asarray(tok),
                                             jnp.int32(S + i), jcfg, dctx)
            ttok = torch.from_numpy(tok)
            l_int, _ = tT.decode_step(tparams, cache_int, ttok, S + i, tcfg, ctx)
            l_t, _ = tT.decode_step(tparams, cache_t, ttok, pos, tcfg, ctx)
            pos.add_(1)
            assert torch.equal(l_t, l_int)
            np.testing.assert_allclose(l_t.numpy(), np.asarray(jlogits), **TOL)
            tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    assert int(pos) == S + STEPS  # the caller's position buffer, untouched by the step
    for a, b in zip(tree_leaves(cache_t), tree_leaves(cache_int)):
        assert torch.equal(a, b)
    for a, b in zip(_np_leaves(cache_t), _np_leaves(jcache)):
        np.testing.assert_allclose(a, b, **TOL)


class EagerCapture:
    """Stands in for ``kernels.graphs.CapturedChain`` on the CPU: the chain
    runs ``warmup`` times on the real inputs, as before a capture, and then
    once per replay over the same static input buffers, its outputs written
    into the same static output buffers each time."""

    def __init__(self, chain, ext_args, device, *, warmup=0):
        self.chain = chain
        self.static_in = [a.clone() for a in ext_args]
        for _ in range(warmup):
            chain(*self.static_in)
        self.static_out = None
        self.replays = 0
        self.released = False

    def replay(self, ext_args=None, *, clone=True):
        for dst, src in zip(self.static_in, ext_args or ()):
            dst.copy_(src)
        outs = self.chain(*self.static_in)
        if self.static_out is None:
            self.static_out = tuple(o.clone() for o in outs)
        else:
            for dst, src in zip(self.static_out, outs):
                dst.copy_(src)
        self.replays += 1
        return tuple(o.clone() for o in self.static_out) if clone else self.static_out

    def release(self):
        self.released = True


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_graph_replay_contract_gives_reference_tokens(arch, monkeypatch):
    jcfg, tcfg = _cfgs(arch)
    want, _ = jserve.serve_smoke(jcfg, n_requests=B, prompt_len=S, decode_len=STEPS,
                                 seed=0)
    # the reference's serve_smoke draws these two from seed 0 and PRNGKey(0)
    params = params_from_numpy(jax.tree.map(np.asarray, _ref_params(jcfg)), CPU)
    batch = jreg.make_batch(jcfg, S, B, train=False)
    monkeypatch.setattr(tserve, "CapturedChain", EagerCapture)
    ctx = Ctx(dtype=torch.float32)
    with torch.inference_mode():
        cache, logits = tT.prefill(params, {"tokens": torch.from_numpy(np.array(batch["tokens"]))},
                                   tcfg, ctx, cache_len=S + STEPS)
        tok = logits.argmax(-1)
        buffers = [t.data_ptr() for t in tree_leaves(cache)]
        graph = tserve.DecodeGraph(params, cache, tok, S, tcfg, ctx)
        tok_buf, pos_buf = graph.chain.static_in
        assert torch.equal(tok_buf, tok) and pos_buf.tolist() == [S]
        out = [tok]
        for _ in range(STEPS):
            logits = graph(tok)
            assert logits is graph.chain.static_out[0]
            tok = logits.argmax(-1)
            out.append(tok)
        graph.release()
    assert graph.chain.replays == STEPS and graph.chain.released
    assert pos_buf.tolist() == [S + STEPS]  # the step advanced its own position
    assert [t.data_ptr() for t in tree_leaves(cache)] == buffers  # written in place
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(), np.asarray(want))


def _host_read(*_a, **_k):
    raise AssertionError("a device value was read on the host during a decode step")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reads_no_device_value_on_the_host(arch, monkeypatch):
    _, tcfg, _, tparams, _, _, cache, logits = _prefilled(arch)
    ctx = Ctx(dtype=torch.float32)
    tok, pos = logits.argmax(-1), torch.tensor([S])
    with torch.inference_mode():
        want, _ = tT.decode_step(tparams, tree_map(torch.clone, cache), tok, S, tcfg, ctx)
        with monkeypatch.context() as mp:
            for name in ("item", "tolist", "__index__", "__int__", "__float__", "__bool__"):
                mp.setattr(torch.Tensor, name, _host_read)
            got, _ = tT.decode_step(tparams, cache, tok, pos, tcfg, ctx)
        assert torch.equal(got, want)
        # on the meta device a host read raises inside torch's own C++ too
        meta = torch.device("meta")
        got, _ = tT.decode_step(tree_map(lambda t: t.to(meta), tparams),
                                tree_map(lambda t: t.to(meta), cache), tok.to(meta),
                                pos.to(meta), tcfg, ctx)
    assert got.device == meta and tuple(got.shape) == tuple(want.shape)


def test_serve_smoke_on_the_cpu_decodes_eagerly_without_a_capture(monkeypatch):
    def no_capture(*_a, **_k):
        raise AssertionError("a CPU serve captured a graph")

    monkeypatch.setattr(tserve, "CapturedChain", no_capture)
    _, tcfg = _cfgs("granite_3_2b")
    tokens, stats = tserve.serve_smoke(tcfg, n_requests=B, prompt_len=5, decode_len=3,
                                       device="cpu")
    assert tokens.shape == (B, 4) and stats.logits_finite
    assert stats.capture_ms == 0.0 and stats.decode_ms_per_token > 0


def test_decode_graph_needs_a_cuda_device():
    _, tcfg = _cfgs("granite_3_2b")
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        tserve.DecodeGraph({}, {}, torch.zeros(B, dtype=torch.long), S, tcfg,
                           Ctx(dtype=torch.float32))
