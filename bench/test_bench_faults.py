"""A run with the timed path broken underneath comes out not correct.

Each cell, cut to a tiny size, is driven through the whole of a run on the
CPU (the harness's look for a card skipped) with one fault of
``bench/faults.py`` planted in the program: for serving a token altered
where it is produced and a decode step that leaves its state unchanged;
for training a step that leaves its state unchanged and half of the batch
left out.  The sound run of the same cell is correct."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from bench import calibrate, faults, harness, testing  # noqa: E402

SERVING = ("granite-3-2b.decode", "granite-moe-3b-a800m.prefill")


def tiny_train():
    """The training cell cut to a tiny size, its activations in float32:
    on the CPU the program's bf16 rounding at this size is not the card's
    at the cell's, and the cell's limits are set from the card's."""
    cell = harness.find_cell("granite-3-2b.train")
    port = dict(cell.model["port"], activation_dtype="float32")
    return dataclasses.replace(cell, model=dict(cell.model, port=port, **testing.TINY),
                               traffic=dict(cell.traffic, batch=2, seq=32))


@pytest.mark.parametrize("fault", sorted(faults.SERVING))
@pytest.mark.parametrize("cell", SERVING)
def test_serving_fault_comes_out_not_correct(cell, fault):
    with faults.SERVING[fault]():
        out = testing.run_tiny(testing.tiny_cell(cell))
    gap = out["checks"]["logit_gap"]
    assert out["correct"] is False and out["failed"] > 0, gap
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("cell,fault", [("granite-3-2b.decode", "token_altered"),
                                        ("granite-3-2b.decode", "cache_unwritten"),
                                        ("granite-moe-3b-a800m.prefill", "token_altered")])
def test_serving_fault_fails_at_the_cells_size(cell, fault):
    """On the card, at the cell's own size and sample, on three seeds.  The
    MoE cell's ``cache_unwritten`` is not here: at 4,096 prompt positions the
    16 keys it leaves out move no served token of the random-weight model
    past the limit (its readings are in the cell's limits file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the fault runs at the cell's own sizes")
    c = harness.find_cell(cell)
    limit = c.limits["logit_gap"]["limit"]
    for seed in (2**31 + 301, 2**31 + 302, 2**31 + 303):
        r = calibrate.reading(c, seed, "cuda:0", control=False, variant=fault)
        assert r["program"] > limit, r


@pytest.mark.parametrize("fault,fails", [("update_skipped", "change_gap"),
                                         ("half_batch", "grad_norm_gap")])
def test_training_fault_comes_out_not_correct(fault, fails):
    with faults.TRAINING[fault]():
        out = testing.run_tiny(tiny_train())
    assert out["correct"] is False and out["failed"] > 0
    c = out["checks"][fails]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("cell", SERVING + ("train",))
def test_sound_run_is_correct(cell):
    c = tiny_train() if cell == "train" else testing.tiny_cell(cell)
    out = testing.run_tiny(c)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
