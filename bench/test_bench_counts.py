"""The benchmark's operation and byte counts (``bench/counts.py``)."""

import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from bench import counts  # noqa: E402

CONFIGS = Path(__file__).resolve().parent / "configs"


def geometry(name):
    return counts.geometry(json.loads((CONFIGS / f"{name}.json").read_text()))


def test_k3_and_k3b_bounds_at_granites_training_shape():
    # PERF.md's kernel table: K3 (8, 32/8, 2048, 64) causal 0.1390 ms and
    # K3b 0.3476 ms, both bound by operations at the bf16 peak
    shape = (8, 32, 8, 2048, 2048, 64)
    assert round(counts.k3_bound_s(*shape, causal=True) * 1e3, 4) == 0.1390
    assert round(counts.k3b_bound_s(*shape, causal=True) * 1e3, 4) == 0.3476
    flops, nbytes = counts.k3_counts(*shape, causal=True)
    assert flops / counts.PEAK_BF16_FLOPS > nbytes / counts.PEAK_HBM_BYTES


@pytest.mark.parametrize("sq,sk,causal,want", [
    (4, 4, True, 10), (4, 4, False, 16), (1, 9, False, 9), (3, 2, True, 2 * 3 // 2 + 2),
])
def test_kept_pairs(sq, sk, causal, want):
    assert counts.kept_pairs(sq, sk, causal) == want


@pytest.mark.parametrize("name,registry", [("granite-3-2b", "granite_3_2b"),
                                           ("granite-moe-3b-a800m", "granite_moe_3b_a800m")])
def test_parameter_count_matches_the_programs_specs(name, registry):
    """The program pads the vocabulary to 49280 rows; the counts hold the
    published 49155."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import count_params

    g = geometry(name)
    cfg = get_config(registry)
    pad = cfg.padded_vocab(1) - cfg.vocab
    assert g.params() == count_params(T.model_param_specs(cfg)) - pad * cfg.d_model


def test_prefill_counts_granite_moe():
    g = geometry("granite-moe-3b-a800m")
    flops, nbytes = counts.prefill_counts(g, 8, 4096)
    per_token_layer = 2 * (g.attn_params() + 8 * 3 * 1536 * 512 + 1536 * 40)
    attn = 32 * 4 * 64 * (4096 * 4097 // 2) * 8 * 24
    assert flops == per_token_layer * 32 * 8 * 4096 + attn + 2 * 1536 * 49155 * 8
    assert nbytes > 2 * g.params()
    assert counts.roofline_s(flops, nbytes) == flops / counts.PEAK_BF16_FLOPS


def test_decode_step_is_bound_by_bytes():
    g = geometry("granite-3-2b")
    flops, nbytes = counts.decode_step_counts(g, 64, 511)
    kv = 40 * 2 * 64 * 512 * 8 * 64 * 2
    assert nbytes == 2 * g.params() + kv + 4 * 64 + 4 * 64 * 49155
    assert counts.roofline_s(flops, nbytes) == nbytes / counts.PEAK_HBM_BYTES
    # one more key a step: the bytes grow by one position of every layer's cache
    assert counts.decode_step_counts(g, 64, 512)[1] - nbytes == 40 * 2 * 64 * 8 * 64 * 2


def test_moe_decode_step_reads_every_expert_once():
    g = geometry("granite-moe-3b-a800m")
    flops, nbytes = counts.decode_step_counts(g, 1, 10)
    experts = 32 * 40 * 3 * 1536 * 512
    assert g.params() > experts and nbytes > 2 * experts
    kv = 32 * 2 * 11 * 8 * 64 * 2
    assert nbytes == 2 * g.params() + kv + 4 + 4 * 49155


def test_train_step_flops_is_6n_plus_attention():
    g = geometry("granite-3-2b")
    n = g.active_matmul() + 2048 * 49155
    attn_fwd = 40 * 4 * 64 * (4096 * 4097 // 2) * 4 * 32
    assert counts.train_step_flops(g, 4, 4096) == 6 * n * 4 * 4096 + 3 * attn_fwd
