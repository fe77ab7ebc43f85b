"""Small cells for the CPU tests: a cell of ``BENCHMARK.json`` with its
configuration cut to a few narrow layers and its traffic to a few short
requests, so that a whole run (set-up, window, check) takes a second on
the CPU through the kernels' plain versions."""

from __future__ import annotations

import dataclasses

from bench import harness

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, intermediate_size=128, vocab_size=300, initializer_range=0.3)


def tiny_cell(name: str, **traffic) -> harness.Cell:
    """A serving cell cut to a tiny size, served in float32: on the CPU the
    program's bf16 rounding at this size is not the card's at the cell's,
    and the cell's limits are set from the card's."""
    cell = harness.find_cell(name)
    port = dict(cell.model["port"], activation_dtype="float32")
    model = dict(cell.model, port=port, **TINY)
    if "num_local_experts" in model:
        model.update(num_local_experts=4, num_experts_per_tok=2)
    mix = dict(cell.traffic, batch=3, prompt_len=16, decode_len=6, sample_requests=3,
               trace_decode_steps=3)
    mix.update(traffic)
    return dataclasses.replace(cell, model=model, traffic=mix)


def run_tiny(cell: harness.Cell, seed: int = 2**31 + 11, trace: bool = False,
             seconds: float = 0.0) -> dict:
    import time

    return harness.run(cell.name, seed, seconds, trace, time.perf_counter(), device="cpu",
                       cell=cell)
