"""The plain reference (``bench/reference/model.py``) against hand-worked
values, and against the program at a tiny size in float32."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from bench.reference import model as ref  # noqa: E402


def test_rmsnorm_by_hand():
    x = torch.tensor([[3.0, 4.0]])
    got = ref.rmsnorm(x, torch.tensor([1.0, 2.0]), 0.0)
    r = math.sqrt((9 + 16) / 2)
    torch.testing.assert_close(got, torch.tensor([[3 / r, 2 * 4 / r]]))


def test_rope_by_hand():
    # hd 2, theta 1: position p turns (x1, x2) by p radians
    x = torch.tensor([1.0, 0.0]).expand(1, 3, 1, 2)
    got = ref.rope(x, 1.0)[0, :, 0]
    want = torch.tensor([[1.0, 0.0], [math.cos(1), math.sin(1)], [math.cos(2), math.sin(2)]])
    torch.testing.assert_close(got, want)


def test_causal_gqa_attention_by_hand():
    # one key/value head shared by two query heads, hd 1: the second query
    # row scores keys 0 and ln 3, so weights 1/4 and 3/4
    q = torch.tensor([[[0.0], [0.0]], [[1.0], [2.0]]])[None]      # (1, S=2, H=2, 1)
    k = torch.tensor([[[0.0]], [[math.log(3)]]])[None]            # (1, 2, K=1, 1)
    v = torch.tensor([[[10.0]], [[20.0]]])[None]
    o = ref.attention(q, k, v, "f32")
    assert o[0, 0, 0, 0] == 10.0 and o[0, 0, 1, 0] == 10.0        # row 0 sees key 0 only
    torch.testing.assert_close(o[0, 1, 0, 0], torch.tensor(0.25 * 10 + 0.75 * 20))
    w = torch.softmax(torch.tensor([0.0, 2 * math.log(3)]), 0)    # head 1: q = 2
    torch.testing.assert_close(o[0, 1, 1, 0], w[0] * 10 + w[1] * 20)


def test_moe_routes_renormalises_and_sums_by_hand():
    # d 1, two experts of width 1, top 1: silu(x g) (x u) d with g = u = 1;
    # the router sends positive x to expert 0 (weight 1 after renorm)
    w = {"router": torch.tensor([[1.0, -1.0]]),
         "w_gate": torch.ones(2, 1, 1), "w_up": torch.ones(2, 1, 1),
         "w_down": torch.tensor([[[2.0]], [[3.0]]])}
    x = torch.tensor([[1.0], [-2.0]])
    got = ref.moe_ffn(x, w, 1, "f32")
    silu = lambda t: t / (1 + math.exp(-t))  # noqa: E731
    torch.testing.assert_close(got, torch.tensor([[silu(1) * 1 * 2], [silu(-2) * -2 * 3]]))
    # top 2: both experts, weighted by the softmax of (x, -x)
    p = torch.softmax(torch.tensor([1.0, -1.0]), 0)
    got2 = ref.moe_ffn(x[:1], w, 2, "f32")
    torch.testing.assert_close(got2, torch.tensor([[silu(1) * (p[0] * 2 + p[1] * 3)]]))


def test_fp8_rounds_to_three_mantissa_bits():
    t = torch.tensor([448.0, 1.1, 0.3])
    got = ref._fp8(t)
    torch.testing.assert_close(got, torch.tensor([448.0, 1.125, 0.3125]))
    a = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    err = (ref.mm(a, a, "fp8") - ref.mm(a, a, "f32")).abs().max()
    assert 1e-3 < err < 1.0


def _tiny_tree(seed=0, moe=False):
    """A 2-layer model in the program's parameter layout, float32."""
    g = torch.Generator().manual_seed(seed)
    n = lambda *s: torch.randn(*s, generator=g) * 0.2  # noqa: E731
    L, d, H, K, hd, f, V = 2, 16, 4, 2, 4, 24, 40
    ffn = ({"router": n(L, d, 4), "w_gate": n(L, 4, d, 8), "w_up": n(L, 4, d, 8),
            "w_down": n(L, 4, 8, d)} if moe else
           {"wi_gate": n(L, d, f), "wi_up": n(L, d, f), "wo": n(L, f, d)})
    tree = {"embed": n(V, d), "final_norm": {"scale": 1 + n(d)},
            "unit": {"l0": {"mixer_norm": {"scale": 1 + n(L, d)},
                            "ffn_norm": {"scale": 1 + n(L, d)},
                            "mixer": {"wq": n(L, d, H, hd), "wk": n(L, d, K, hd),
                                      "wv": n(L, d, K, hd), "wo": n(L, H, hd, d)},
                            "ffn": ffn}}}
    config = {"num_hidden_layers": L, "hidden_size": d, "num_attention_heads": H,
              "num_key_value_heads": K, "head_dim": hd, "intermediate_size": 8 if moe else f,
              "vocab_size": V, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
              "num_experts_per_tok": 2, "num_local_experts": 4 if moe else 0,
              "tie_word_embeddings": True}
    return tree, config


@pytest.mark.parametrize("moe", [False, True])
def test_reference_matches_the_program_in_float32(moe):
    """The program's prefill logits at every position of a tiny model, in
    float32 on the CPU, within 1e-4 of the reference's: the two compute the
    same function."""
    from repro_torch.configs.base import LayerSpec, ModelConfig
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import Ctx

    tree, c = _tiny_tree(1, moe)
    cfg = ModelConfig(name="tiny", family="moe" if moe else "dense", d_model=16, n_layers=2,
                      n_heads=4, n_kv_heads=2, d_ff=24, vocab=40, head_dim=4,
                      unit=(LayerSpec("attn", "moe" if moe else "dense"),),
                      tie_embeddings=True, n_experts=4 if moe else 0, top_k=2 if moe else 0,
                      moe_d_ff=8 if moe else 0, activation_dtype="float32")
    tokens = torch.randint(0, 40, (2, 7), generator=torch.Generator().manual_seed(2))
    want = ref.logits_at(tree, c, tokens, 0)
    pad = dataclasses.replace(cfg).padded_vocab(1) - 40
    params = dict(tree, embed=torch.cat([tree["embed"], torch.zeros(pad, 16)]))
    with torch.no_grad():
        hidden, _, _ = T.forward(params, {"tokens": tokens}, cfg, Ctx(dtype=torch.float32))
        got = T.logits_for(params, hidden.reshape(-1, 16), cfg, Ctx(dtype=torch.float32))
    torch.testing.assert_close(got.view(2, 7, -1)[..., :40], want, rtol=1e-4, atol=1e-4)


def test_served_gaps():
    tree, c = _tiny_tree(3)
    prompts = torch.randint(0, 40, (2, 5), generator=torch.Generator().manual_seed(4))
    # greedy tokens of the reference itself: every gap 0
    toks = prompts
    served = []
    for _ in range(4):
        nxt = ref.logits_at(tree, c, toks, toks.shape[1] - 1)[:, 0].argmax(-1)
        served.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], 1)
    served = torch.stack(served, 1)
    gaps = ref.served_gaps(tree, c, prompts, served)
    assert gaps.shape == (2, 4) and gaps.abs().max() == 0
    # a token altered: its gap is the logit difference; an id past the vocabulary: inf
    bad = served.clone()
    logits = ref.logits_at(tree, c, torch.cat([prompts, served[:, :-1]], 1), 4)
    alt = logits[0, 2].argsort()[-2]
    bad[0, 2] = alt
    bad[1, 1] = 40
    gaps = ref.served_gaps(tree, c, prompts, bad)
    torch.testing.assert_close(gaps[0, 2], logits[0, 2].max() - logits[0, 2, alt])
    assert gaps[1, 1] == float("inf")
    # the control: the fp8 reference's own picks, judged in float32
    ctl = ref.served_gaps(tree, c, prompts, served, "fp8", control=True)
    assert ctl.shape == (2, 4) and (ctl >= 0).all()
