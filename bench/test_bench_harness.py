"""The harness of ``bench/``: its arguments, finding a cell's files by
name, the result line, the import check, the weights, the trace's
reduction, and ``BENCHMARK.json`` against the contract's shape."""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from bench import harness, testing  # noqa: E402
from bench import trace as tr  # noqa: E402
from bench import weights  # noqa: E402
from bench.run import parse  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_arguments():
    a = parse(["--workload", "x.y", "--seed", str(2**31 + 5), "--seconds", "30", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("x.y", 2**31 + 5, 30.0, 1)
    with pytest.raises(SystemExit):
        parse(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and BENCH["command"] == ["python3", "bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and m["workloads"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = {m["name"] for m in harness.metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_for(BENCH, w["name"], True)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.find_cell(cell)
    assert c.model["name"] == c.entry["config"]
    assert {"kind", "batch"} <= set(c.traffic)
    assert c.limits and all(v["limit"] > 0 for v in c.limits.values())
    for m in c.metrics[False] + c.metrics[True]:
        assert callable(harness.load_reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_port_config_is_the_programs(cell):
    """The program's registered configuration, but for the norm's epsilon,
    which the run takes from the published file (the registry has 1e-5)."""
    from repro_torch.configs.registry import get_config

    c = harness.find_cell(cell)
    program = get_config(c.model["port"]["registry"])
    published = dataclasses.replace(program, norm_eps=c.model["rms_norm_eps"])
    assert harness.port_config(c.model) == published


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    """A copy of the benchmark with a new mix, limits, metric and cell,
    every existing file untouched: the new cell runs and reports the new
    metric."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "granite-3-2b.tiny", "config": "granite-3-2b",
                               "traffic": "tiny", "chips": 1, "why": "a test's"})
    bench["per_layer"].append({"name": "batches_seen", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "tpot_ms", "workloads": ["granite-3-2b.tiny"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "granite-3-2b.decode" in m["workloads"]:
            m["workloads"].append("granite-3-2b.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = tmp_path / "bench"
    mix = dict(json.loads((b / "traffic" / "decode.json").read_text()), batch=2, prompt_len=8,
               decode_len=3, sample_requests=2)
    (b / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (b / "limits" / "granite-3-2b.tiny.json").write_text('{"logit_gap": {"limit": 0.5}}')
    (b / "metrics" / "batches_seen.py").write_text("def read(rec):\n"
                                                   "    return len(rec.batches)\n")
    cell = harness.find_cell("granite-3-2b.tiny", tmp_path)
    assert cell.traffic["batch"] == 2
    cell.model.update(testing.TINY)
    import time

    out = harness.run(cell.name, 5, 0.0, True, time.perf_counter(), device="cpu",
                      root=tmp_path, cell=cell)
    assert out["metrics"]["batches_seen"] == {"value": 2, "unit": "count"}  # + the traced one


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    cell = testing.tiny_cell("granite-moe-3b-a800m.prefill")
    out = testing.run_tiny(cell, trace=trace)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == trace
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == (6 if trace else 3)  # a traced run serves one more batch
    want = {m["name"] for m in cell.metrics[trace]}
    got = set(out["metrics"])
    # on the CPU the profiler sees no device kernel: those readers return nothing
    assert got <= want and (got == want if not trace else "prefill_mfu" in got)
    for m in out["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]
    if not trace:   # the set-up's phases add up to it
        assert sum(out["setup_parts"].values()) == pytest.approx(out["metrics"]["setup_s"]["value"])
    assert set(out["checks"]) == {"logit_gap", "tokens_past_vocab",
                                  "batches_with_nonfinite_logits"}
    json.dumps(out)


def test_serving_marks_on_the_harness_clock():
    """Each served batch's marks (submitted, first tokens, first decode
    step, returned) come in that order from the harness's own clock, and
    the program's functions are put back after the run."""
    import time

    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T

    before = (T.prefill, T.decode_step, S.DecodeGraph.__call__)
    rec, _ = harness.run_serving(testing.tiny_cell("granite-3-2b.decode"), 3, 0.0, False,
                                 "cpu", time.perf_counter())
    assert (T.prefill, T.decode_step, S.DecodeGraph.__call__) == before
    for b in rec.batches:
        assert b.t_submit < b.t_first < b.t_decode < b.t_return


def test_no_card_no_result():
    """Without a CUDA device a run prints no result and exits 3: it never
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert p.returncode == 3 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1, "repro": 1,
            "repro.core.graph": 1, "repro_torch": 1, "repro_torch.models": 1, "reprox": 1}
    assert harness.forbidden_modules(mods) == ["flax", "jax", "jax.numpy", "jaxlib.xla",
                                               "repro", "repro.core.graph"]


def test_what_a_run_loads_imports_no_jax_and_no_reference_package():
    """Every module of the benchmark and the program modules a run reaches,
    imported in a fresh process: none is jax, jaxlib, flax or repro."""
    code = (
        "import sys, importlib\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from bench import harness, calibrate, counts, weights, trace, run\n"
        "from bench.reference import model\n"
        "import repro_torch.launch.serve, repro_torch.launch.steps\n"
        "import repro_torch.models.transformer, repro_torch.kernels.ops\n"
        "import json, glob\n"
        "for f in sorted(glob.glob(sys.argv[1] + '/bench/metrics/*.py')):\n"
        "    harness.load_reader(f.rsplit('/', 1)[1][:-3])\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                       env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_weights_drawn_from_the_seed():
    from repro_torch.models import transformer as T
    from repro_torch.models.params import F32_PARAMS, tree_leaves

    cell = testing.tiny_cell("granite-moe-3b-a800m.prefill")
    cfg = harness.port_config(cell.model)
    specs = T.model_param_specs(cfg)
    a = weights.draw(specs, cell.model, 7, "cpu", torch.bfloat16, F32_PARAMS)
    b = weights.draw(specs, cell.model, 7, "cpu", torch.bfloat16, F32_PARAMS)
    c = weights.draw(specs, cell.model, 8, "cpu", torch.bfloat16, F32_PARAMS)
    for x, y, z, s in zip(tree_leaves(a), tree_leaves(b), tree_leaves(c), tree_leaves(specs)):
        assert tuple(x.shape) == s.shape and torch.equal(x, y) and not torch.equal(x, z)
        assert x.dtype == (torch.float32 if s.init == "ones" else torch.bfloat16)
    v = cell.model["vocab_size"]
    assert a["embed"][v:].abs().max() == 0 and a["embed"][:v].std() > 0.05
    assert abs(a["final_norm"]["scale"].mean().item() - 1) < 0.1


def test_trace_busy_union_and_breakdown():
    t = tr.Trace(kernels=[("a", 0, 10), ("b", 5, 15), ("a", 20, 30), ("c", 50, 60)],
                 host=[("step", 0, 100), ("sync", 31, 49), ("copy", 16, 18)],
                 window_s=100e-6, about="test")
    assert t.busy_intervals() == [(0, 15), (20, 30), (50, 60)]
    assert t.busy_s == pytest.approx(35e-6)
    assert t.kernel_s("a") == pytest.approx(20e-6) and t.kernel_count("a", "c") == 3
    br = t.breakdown()
    assert br["device_ops"][0] == ["a", pytest.approx(20e-6)]
    assert dict((k, v) for k, v in br["idle_gaps"]) == {"copy": pytest.approx(5e-6),
                                                        "sync": pytest.approx(20e-6)}
