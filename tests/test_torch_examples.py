"""The ``examples/*_torch.py`` twins against the reference's ``examples/``.

Each twin runs with ``--device cpu`` (where it takes the flag) and each
reference as it ships, every one a subprocess of its own, all started
together, each under its own time limit.  The scheduler core the twins run
is the reference's copied verbatim, so their deterministic lines must equal
the reference's character for character: the Formula (1)/(2) targets, the
policies' makespans, transfers and placements, the partition's DOT file,
the online partitioner's log, the elastic replan and the serving
scheduler lines.  Wall-clock numbers are left out: the executed makespan,
tok/s, and the arena table's ``decision_ms`` and ``offline_ms`` columns.

The reference quickstart writes its DOT file to a fixed
``/tmp/quickstart_partition.dot``; it runs here through a shim that sends
that ``open`` into the run's own directory, and the twin's file is also
held against the reference's ``to_dot`` called in this process.

``train_lm_torch``'s config is the reference's field for field (loaded with
``runpy`` under another name than ``__main__``; the reference script itself
trains through a sharded step that is red on this jax, ROADMAP section 3,
fault 5), and a short run logs two losses, the second lower.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import importlib.util
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
# each subprocess's limit: the train_lm twin's 40 steps take ~100 s alone on
# 2 CPU threads (AdamW's passes over 80M parameters, ~2.4 s a step) and
# more beside the suite's other workers
TIMEOUT_S = 600
# the train_lm twin's short run: 40 steps log at 20 and 40 (log_every 20);
# 2 x 32 tokens a step keep one batch's loss from swamping the fall
TRAIN_ARGS = ["--steps", "40", "--batch", "2", "--seq", "32", "--device", "cpu"]
# CPU threads a subprocess may use: beside the suite's other workers, more
# threads only contend (the train_lm twin's steps slowed ~10x at the default)
THREADS = {"train_lm_torch": "2"}
# the arena table's wall-clock columns (repro/core/arena.py:140-146)
WALL_COLUMNS = ("decision_ms", "offline_ms")
# the reference quickstart's fixed DOT path (examples/quickstart.py:45-46)
REF_DOT = "/tmp/quickstart_partition.dot"
# runs a script as __main__ with one path it opens sent elsewhere:
# python -c SHIM script from_path to_path
SHIM = """\
import builtins, runpy, sys
script, src, dst = sys.argv[1:4]
_open = builtins.open
builtins.open = lambda f, *a, **k: _open(dst if f == src else f, *a, **k)
sys.argv = [script]
runpy.run_path(script, run_name="__main__")
"""


def _start(cmd: list[str], tmp: Path, threads: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", TMPDIR=str(tmp),
               OMP_NUM_THREADS=threads)
    return subprocess.Popen([sys.executable, *cmd], cwd=tmp, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: stdout lines} of every twin and reference, each exit 0."""
    tmp = tmp_path_factory.mktemp("examples")
    jobs = {
        "train_lm_torch": ["train_lm_torch.py", *TRAIN_ARGS, "--ckpt-dir", str(tmp / "ckpt")],
        "quickstart_torch": ["quickstart_torch.py", "--device", "cpu"],
        "heterogeneous_serving": ["heterogeneous_serving.py"],
        "heterogeneous_serving_torch": ["heterogeneous_serving_torch.py", "--device", "cpu"],
        "online_repartition": ["online_repartition.py"],
        "online_repartition_torch": ["online_repartition_torch.py"],
        "elastic_repartition": ["elastic_repartition.py"],
        "elastic_repartition_torch": ["elastic_repartition_torch.py"],
    }
    cmds = {name: [str(EXAMPLES / script), *args] for name, (script, *args) in jobs.items()}
    cmds["quickstart"] = ["-c", SHIM, str(EXAMPLES / "quickstart.py"), REF_DOT,
                          str(tmp / "quickstart_partition.dot")]
    procs = {name: _start(cmd, tmp, THREADS.get(name, "1")) for name, cmd in cmds.items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, (name, stdout[-2000:], stderr[-3000:])
            out[name] = stdout.splitlines()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    out["tmp"] = tmp
    return out


def test_quickstart_twin_prints_the_references_schedule(runs):
    ref, twin = runs["quickstart"], runs["quickstart_torch"]
    assert len(ref) == len(twin) == 6
    assert twin[:4] == ref[:4]     # Formula (1)/(2), eager, dmda, gp
    assert twin[4] == f"partition visualization -> {runs['tmp'] / 'quickstart_torch_partition.dot'}"
    # the executed placement's transfers; its makespan is wall clock
    pat = re.compile(r"real execution: [0-9.]+ ms, (\d+) inter-group transfers")
    assert pat.fullmatch(twin[5]).group(1) == pat.fullmatch(ref[5]).group(1)


def _reference_dot() -> str:
    """The reference quickstart's partition DOT, built in this process
    through its scheduler core (steps 1-3)."""
    from repro.core.cost import paper_calibrated_model
    from repro.core.dot import to_dot
    from repro.core.graph import generate_paper_dag
    from repro.core.schedulers import make_policy
    from repro.core.simulate import make_cpu_gpu_platform, simulate

    g = paper_calibrated_model().weight_graph(generate_paper_dag("matmul"), {"matmul": 1024})
    gp = make_policy("gp")
    simulate(g, gp, make_cpu_gpu_platform())
    return to_dot(g, {k: (0 if v == "cpu" else 1) for k, v in gp.assignment.items()})


def test_quickstart_twin_writes_the_references_partition(runs):
    twin = (runs["tmp"] / "quickstart_torch_partition.dot").read_text()
    assert twin == (runs["tmp"] / "quickstart_partition.dot").read_text()
    assert twin == _reference_dot()
    assert twin.count("->") == 75   # the paper DAG's 75 dependencies


def test_heterogeneous_serving_twin_prints_the_references_schedules(runs):
    ref, twin = runs["heterogeneous_serving"], runs["heterogeneous_serving_torch"]
    sched = [line for line in ref if line.startswith("[serve] scheduler=")]
    assert [p.split("=")[1].split(":")[0] for p in sched] == ["gp", "eager", "dmda", "heft"]
    assert [line for line in twin if line.startswith("[serve] scheduler=")] == sched
    smoke = [line for line in twin if line.startswith("[serve] granite-3-2b-smoke: 6 requests")]
    assert len(smoke) == 1 and "(cpu;" in smoke[0]


def _without_wall_columns(lines: list[str]) -> list[list[str]]:
    """The arena table's rows as fields, the wall-clock columns dropped."""
    head = lines[0].split()
    drop = {head.index(c) for c in WALL_COLUMNS}
    return [[f for i, f in enumerate(line.split()) if i not in drop]
            for line in lines if not set(line) <= {"-", " "}]


def test_online_repartition_twin_prints_the_references_log_and_arena(runs):
    ref, twin = runs["online_repartition"], runs["online_repartition_torch"]
    split = ref.index("SchedulerArena on a churning request stream (drop at step 3):") + 1
    assert twin[:split] == ref[:split]
    assert len(twin) == len(ref) == split + 7   # header, rule, five policies
    assert _without_wall_columns(twin[split:]) == _without_wall_columns(ref[split:])


def test_elastic_repartition_twin_prints_the_references_replan(runs):
    ref, twin = runs["elastic_repartition"], runs["elastic_repartition_torch"]
    assert twin == ref and ref[-1].startswith("podB excluded; cut_edges:")


def test_train_lm_twin_config_is_the_references():
    ref = runpy.run_path(str(EXAMPLES / "train_lm.py"), run_name="train_lm_reference")["CFG"]
    spec = importlib.util.spec_from_file_location("train_lm_torch", EXAMPLES / "train_lm_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    fields = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(twin.CFG)] == fields
    for name in fields:
        got, want = getattr(twin.CFG, name), getattr(ref, name)
        if name in ("unit", "prefix"):
            got = [dataclasses.astuple(s) for s in got]
            want = [dataclasses.astuple(s) for s in want]
        assert got == want, name
    assert (twin.CFG.n_layers, twin.CFG.d_model, twin.CFG.n_heads, twin.CFG.n_kv_heads) == \
        (8, 768, 12, 4)


def test_train_lm_twin_loss_falls(runs):
    lines = runs["train_lm_torch"]
    losses = [float(m.group(1)) for line in lines
              if (m := re.match(r"\[train\] step\s+\d+ loss ([0-9.]+)", line))]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert lines[-1] == f"first logged loss {losses[0]:.3f} -> last {losses[1]:.3f}"
    assert "1 device (cpu), batch 2 x 32" in lines[0]
