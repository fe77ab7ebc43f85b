"""The controls of the output checks.  Serving: the reference computed one
precision below the configuration's bf16 (fp8 e4m3 operands in every
product) in the program's place; its greedy tokens, judged by the float32
reference, must read over the cell's limit where the program reads under
it.  Training: the program's own bf16 path for the weights and the AdamW
state, one precision below the configuration's float32, and half of the
batch left out, must each fail a number.

On the card at the cells' own sizes on three seeds, as
``bench/calibrate.py`` reads them; here on the CPU the serving readings at
a tiny size (the training faults' tiny runs are ``test_bench_faults.py``'s)."""

import pytest

torch = pytest.importorskip("torch")

from bench import calibrate, harness, testing  # noqa: E402

CELLS = ("granite-3-2b.decode", "granite-moe-3b-a800m.prefill")


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_over_the_program_at_a_tiny_size(cell):
    c = testing.tiny_cell(cell, decode_len=12, sample_requests=3)
    rows = [calibrate.reading(c, s, "cpu") for s in (2**31 + 1, 2**31 + 2, 2**31 + 3)]
    assert max(r["control"] for r in rows) > max(r["program"] for r in rows)


def test_reading_samples_as_many_requests_as_a_run():
    """A reading serves batches until it can sample the cell's
    ``sample_requests``, as a run's window does."""
    c = testing.tiny_cell(CELLS[1], decode_len=3, sample_requests=5)
    r = calibrate.reading(c, 2**31 + 5, "cpu", control=False, variant="token_altered")
    assert r["requests"] == 5 and r["variant"] == "token_altered"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's own sizes")
    c = harness.find_cell(cell)
    limit = c.limits["logit_gap"]["limit"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = calibrate.reading(c, seed, "cuda:0")
        assert r["program"] <= limit < r["control"], r


@pytest.mark.parametrize("variant,fails", [("control", "change_gap"),
                                           ("half_batch", "grad_norm_gap")])
def test_training_control_and_fault_fail_at_the_cells_size(variant, fails):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's own sizes")
    c = harness.find_cell("granite-3-2b.train")
    for seed in (2**31 + 201, 2**31 + 202, 2**31 + 203):
        r = calibrate.reading_train(c, seed, "cuda:0", variant)
        assert r[fails] > c.limits[fails]["limit"], r
