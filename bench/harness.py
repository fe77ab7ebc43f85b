"""The benchmark of the PyTorch port, driven by data.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, found as ``bench/configs/<config>.json``, and a traffic mix,
``bench/traffic/<traffic>.json``; the limits its output check holds are in
``bench/limits/<cell>.json``, and each metric is read by
``bench/metrics/<metric>.py``.  A new cell, configuration, mix or metric
is new files and new entries; no file here names one.

A run: the weights drawn on the card from the seed (``weights.py``), the
cell's shapes warmed through the program's own entry (set-up), then the
mix driven for ``--seconds`` (the window), then the output check against
the plain reference (``reference/``), then one JSON line.  With ``--trace
1`` one more batch after the window runs under ``torch.profiler`` (a
slice of it: ``trace_decode_steps`` of its decode steps) and the line
carries the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run (compared whole:
# ``repro_torch``, the program, begins with ``repro``)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


class NoDevice(RuntimeError):
    """The run cannot measure: no CUDA device, or fewer than the cell asks for."""


def derive_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one use of the run's ``seed``."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict       # the workload entry of BENCHMARK.json
    model: dict       # bench/configs/<config>.json
    traffic: dict     # bench/traffic/<traffic>.json
    limits: dict      # bench/limits/<cell>.json
    metrics: dict     # trace 0 / 1 -> [metric entries this cell reports]


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    ones, else the end-to-end ones.  An end-to-end metric with
    ``workloads`` is reported in those cells, without it in every cell; a
    per-layer metric names its cells in ``workloads``."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
    entry = entries[name]
    base = root / "bench"
    return Cell(name=name, entry=entry,
                model=load_json(base / "configs" / f"{entry['config']}.json"),
                traffic=load_json(base / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(base / "limits" / f"{name}.json"),
                metrics={t: metrics_for(bench, name, t) for t in (False, True)})


def load_reader(name: str, root: Path = ROOT):
    """``bench/metrics/<name>.py``'s ``read(record)``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_config(model: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import LayerSpec, ModelConfig

    port = model["port"]
    moe = port["ffn"] == "moe"
    d, heads = model["hidden_size"], model["num_attention_heads"]
    return ModelConfig(
        name=model["name"], family=port["family"], d_model=model["hidden_size"],
        n_layers=model["num_hidden_layers"], n_heads=model["num_attention_heads"],
        n_kv_heads=model["num_key_value_heads"],
        d_ff=model["intermediate_size"], vocab=model["vocab_size"],
        head_dim=0 if model["head_dim"] == d // heads else model["head_dim"], unit=(LayerSpec(port["mixer"], port["ffn"]),),
        rope_theta=model["rope_theta"], norm_eps=model["rms_norm_eps"],
        tie_embeddings=model["tie_word_embeddings"],
        n_experts=model.get("num_local_experts", 0) if moe else 0,
        top_k=model.get("num_experts_per_tok", 0) if moe else 0,
        moe_d_ff=model["intermediate_size"] if moe else 0,
        activation_dtype=port.get("activation_dtype", "bfloat16"))


def set_cache_dirs(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run in it builds or compiles (the program's own CUDA library is
    built into ``src/repro_torch/csrc/build/``, inside the checkout too).
    That holds for Python's bytecode as well, of the framework's modules
    too: called before ``torch`` is imported, a run reads the bytecode its
    checkout's first run wrote instead of compiling every module again."""
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False


def require_cuda(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("CUDA is not available: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, {torch.cuda.device_count()} found")


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


# ---------------------------------------------------------------------------
# serving: a closed loop of batches through the program's serving entry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Batch:
    """One served batch, with the harness's clock readings in it."""
    prompts: object          # (B, S) int32 on the device
    tokens: object           # (B, D + 1) served tokens, on the host
    stats: object            # the program's ServeStats
    t_submit: float          # the serving entry called
    t_first: float           # the prefill's first tokens made
    t_decode: float | None   # the first decode step begun (None: no decode step)
    t_return: float          # the entry returned the tokens
    profiled: bool = False


@dataclasses.dataclass
class Record:
    """What a run saw; the metric readers take it."""
    cell: Cell
    geometry: object         # counts.Geometry
    setup_s: float
    setup_marks: dict        # set-up phase -> the clock at its end
    batches: list = dataclasses.field(default_factory=list)
    trace: object = None     # trace.Trace of the profiled slice

    @property
    def window_s(self) -> float:
        return self.batches[-1].t_return - self.batches[0].t_submit

    @property
    def attempted(self) -> int:
        return sum(b.tokens.shape[0] for b in self.batches)

    def timed(self) -> list:
        """The window's batches: those that ran without the profiler."""
        return [b for b in self.batches if not b.profiled]


class _Marks:
    """The harness's own clock inside a served batch: ``first`` when the
    prefill has returned and the device is synchronised (the batch's first
    tokens are made), ``decode`` when the first decode step begins, the
    device synchronised (the decode graph's first replay on the card; the
    first eager step on the CPU, which decodes without a graph).  The
    program's functions are wrapped while the marks are on and put back
    after; the program synchronises at both points itself, so the marks add
    no wait."""

    def __init__(self, transformer, graph_cls, on_card: bool, clock):
        import torch

        self.clock = clock
        self.sync = torch.cuda.synchronize if on_card else (lambda: None)
        self.prefill = (transformer, "prefill")
        self.step = (graph_cls, "__call__") if on_card else (transformer, "decode_step")
        self.first = self.decode = None
        self.saved: list = []

    def reset(self) -> None:
        self.first = self.decode = None

    def _now(self) -> float:
        self.sync()
        return self.clock()

    def __enter__(self):
        prefill, step = getattr(*self.prefill), getattr(*self.step)
        self.saved = [(*self.prefill, prefill), (*self.step, step)]

        def timed_prefill(*args, **kwargs):
            out = prefill(*args, **kwargs)
            self.first = self._now()
            return out

        def timed_step(*args, **kwargs):
            if self.decode is None:
                self.decode = self._now()
            return step(*args, **kwargs)

        setattr(*self.prefill, timed_prefill)
        setattr(*self.step, timed_step)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in self.saved:
            setattr(owner, name, orig)


class _StopAfterReplays:
    """Stops the profiler after the ``n``-th decode step of the batch it
    profiles: the program's ``DecodeGraph.__call__`` wrapped for that batch
    only, the device synchronised before the stop."""

    def __init__(self, graph_cls, prof, n: int, clock):
        self.cls, self.prof, self.n, self.clock = graph_cls, prof, n, clock
        self.calls, self.stopped_at = 0, None
        self.orig = graph_cls.__call__

    def __enter__(self):
        outer = self

        def call(graph, tokens):
            out = outer.orig(graph, tokens)
            outer.calls += 1
            if outer.calls == outer.n:
                outer.stop()
            return out

        self.cls.__call__ = call
        return self

    def stop(self):
        import torch

        if self.stopped_at is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.stopped_at = self.clock()
            self.prof.stop()

    def __exit__(self, *exc):
        self.cls.__call__ = self.orig
        self.stop()


def run_serving(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
                clock=time.perf_counter, min_batches: int = 1) -> tuple[Record, dict]:
    """Set-up and window of a serving cell (with ``trace``, one more batch
    under the profiler); the window serves ``min_batches`` batches at the
    least.  -> (the record, the weights for the check)."""
    import torch

    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    from repro_torch.models.params import F32_PARAMS

    from . import counts, weights

    marks = {"program_import": clock()}
    model, mix = cell.model, cell.traffic
    B, P, D = mix["batch"], mix["prompt_len"], mix["decode_len"]
    cfg = port_config(model)
    dev = torch.device(device)
    # the served dtype, cast once here: the entry's own cast is then a no-op
    params = weights.draw(T.model_param_specs(cfg), model, derive_seed(seed, "weights"), dev,
                          getattr(torch, cfg.activation_dtype), F32_PARAMS)
    marks["weights"] = clock()
    gen = torch.Generator(dev).manual_seed(derive_seed(seed, "prompts"))
    timer = _Marks(T, S.DecodeGraph, dev.type == "cuda", clock)

    def prompts():
        return torch.randint(0, model["vocab_size"], (B, P), generator=gen, device=dev,
                             dtype=torch.int32)

    def submit(toks, profiled=False):
        timer.reset()
        t0 = clock()
        out, stats = S.serve_smoke(cfg, n_requests=B, prompt_len=P, decode_len=D,
                                   params=params, batch={"tokens": toks}, device=dev)
        return Batch(toks, out, stats, t0, timer.first, timer.decode, clock(), profiled)

    with timer:
        submit(prompts())                                # warm-up: the cell's shapes
        marks["warm_up"] = clock()
        rec = Record(cell=cell, geometry=counts.geometry(model),
                     setup_s=marks["warm_up"] - t_start, setup_marks=marks)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        toks = prompts()
        t_window = clock()
        while True:
            rec.batches.append(submit(toks))
            toks = prompts()
            if clock() - t_window >= seconds and len(rec.batches) >= min_batches:
                break
        if trace:
            # last, so that no batch the spans are read from runs after the
            # profiler, which leaves launches and allocations slower
            rec.batches.append(_profiled(submit, toks, dev, mix, S.DecodeGraph, clock, rec))
    return rec, params


def _profiled(submit, toks, dev, mix, graph_cls, clock, rec) -> Batch:
    """One batch with ``torch.profiler`` on from its submission to the end
    of its ``trace_decode_steps``-th decode step (or of the batch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import trace as tr

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    n = mix["trace_decode_steps"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.start()
    t0 = clock()
    with _StopAfterReplays(graph_cls, prof, n, clock) as stopper:
        batch = submit(toks, profiled=True)
    steps = min(n, mix["decode_len"])
    about = (f"one batch of {mix['batch']} from its submission through the prefill, the "
             f"decode graph's capture and {steps} of its {mix['decode_len']} decode steps")
    rec.trace = tr.from_profiler(prof, stopper.stopped_at - t0, about)
    return batch


def sample(rec: Record, seed: int) -> tuple:
    """(prompts, served tokens) of a sample of the window's requests drawn
    from the seed, on the device."""
    import torch

    mix = rec.cell.traffic
    everyone = [(i, r) for i, b in enumerate(rec.batches) for r in range(b.tokens.shape[0])]
    pick = random.Random(derive_seed(seed, "sample")).sample(
        everyone, min(mix["sample_requests"], len(everyone)))
    dev = rec.batches[0].prompts.device
    prompts = torch.stack([rec.batches[i].prompts[r] for i, r in pick]).to(dev)
    served = torch.stack([rec.batches[i].tokens[r] for i, r in pick]).to(dev)
    return prompts, served


def check_serving(rec: Record, params, seed: int) -> tuple[dict, int]:
    """The served tokens of a sample of the window's requests against the
    reference: ``({name: (value, limit)}, requests failed)``."""
    import torch

    from .reference import model as ref

    cell = rec.cell
    gaps = ref.served_gaps(params, cell.model, *sample(rec, seed))
    inside = torch.isfinite(gaps)
    worst = gaps[inside].max().item() if inside.any() else 0.0
    nonfinite = sum(not b.stats.logits_finite for b in rec.batches)
    limit = cell.limits["logit_gap"]["limit"]
    checks = {"logit_gap": (worst, limit),
              "tokens_past_vocab": (int((~inside).sum()), 0),
              "batches_with_nonfinite_logits": (nonfinite, 0)}
    failed = (int(((gaps > limit) | ~inside).any(-1).sum())
              + nonfinite * cell.traffic["batch"])
    return checks, failed


def passed(checks: dict) -> bool:
    """Every number compared at or under its limit."""
    return all(v <= limit for v, limit in checks.values())


# ---------------------------------------------------------------------------
# training: steps back to back through the program's train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainRecord:
    """What a training run saw; the metric readers take it."""
    cell: Cell
    geometry: object
    setup_s: float
    setup_marks: dict            # set-up phase -> the clock at its end
    steps: int = 0               # steps in the window
    window_s: float = 0.0        # its start to the synchronise after its last step
    first: dict = dataclasses.field(default_factory=dict)   # the checked steps' readings
    trace: object = None

    @property
    def attempted(self) -> int:
        return self.steps + self.cell.traffic["check_steps"]


def run_training(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
                 clock=time.perf_counter, dtype=None) -> tuple[TrainRecord, dict]:
    """Set-up (the weights, the train step and its optimizer state, driven
    through the first ``check_steps`` steps, whose losses, first gradient
    and change the check compares), the window, and with ``trace`` three
    more steps under the profiler.  ``dtype`` (float32 unless a control
    asks for the program's bf16 path) is the weights' and the optimizer
    state's."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    from . import counts, weights
    from .reference.train import change_norms, sq_sum

    marks = {"program_import": clock()}
    model, mix = cell.model, cell.traffic
    dtype = dtype or torch.float32
    cfg = port_config(model)
    if dtype != torch.float32:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16", optstate_dtype="bfloat16")
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda *a: None)
    step, p_specs, _, _ = make_train_step(cfg, make_host_mesh())
    wseed = derive_seed(seed, "weights")
    params = weights.draw(p_specs, model, wseed, dev, dtype)
    state = adamw.init_state(params, adamw.AdamWConfig(state_dtype=dtype))
    marks["weights"] = clock()
    gen = torch.Generator(dev).manual_seed(derive_seed(seed, "tokens"))
    B, S = mix["batch"], mix["seq"]

    def batch():
        seq = torch.randint(0, model["vocab_size"], (B, S + 1), generator=gen, device=dev,
                            dtype=torch.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    first = {"loss": [], "grad_norm": [], "batches": []}
    b1 = mix["optimizer"]["b1"]
    for i in range(mix["check_steps"]):
        b = batch()
        first["batches"].append(b)
        params, state, out = step(params, state, b)
        first["loss"].append(out["loss"].item())
        first["grad_norm"].append(out["grad_norm"].item())
        if i == 0:       # the gradient as the optimizer got it: m = (1 - b1) g
            first["first_grad"] = {n: math.sqrt(sq_sum(mo["m"])) / (1 - b1)
                                   for n, mo in _moments(state)}
    before = weights.draw(p_specs, model, wseed, dev, dtype)
    first["change"] = change_norms(params, before)
    del before
    sync()
    marks["warm_up"] = clock()
    rec = TrainRecord(cell=cell, geometry=counts.geometry(model),
                      setup_s=marks["warm_up"] - t_start, setup_marks=marks, first=first)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = clock()
    while True:
        params, state, _ = step(params, state, batch())
        rec.steps += 1
        if clock() - t0 >= seconds:
            break
    sync()
    rec.window_s = clock() - t0
    if trace:
        rec.trace = _profiled_steps(lambda: step(params, state, batch()), dev, mix, clock)
    return rec, {"weights_seed": wseed, "specs": p_specs, "dtype": dtype}


def _moments(state):
    """(leaf name, {"m", "v"}) in the parameters' order."""
    def walk(t, path=()):
        if isinstance(t, dict) and set(t) != {"m", "v"}:
            for k in sorted(t):
                yield from walk(t[k], path + (k,))
        else:
            yield "/".join(path), t
    return walk(state["moments"])


def _profiled_steps(run_step, dev, mix, clock):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import trace as tr

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda *a: None)
    n = mix["trace_steps"]
    prof = profile(activities=acts)
    sync()
    prof.start()
    t0 = clock()
    for _ in range(n):
        run_step()
    sync()
    window = clock() - t0
    prof.stop()
    return tr.from_profiler(prof, window, f"{n} training steps after the window")


def _gap(prog: dict, ref: dict, skip=()) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    import statistics

    med = statistics.median(ref.values())
    return max(abs(prog[n] - r) / max(r, med) for n, r in ref.items() if n not in skip)


def check_training(rec: TrainRecord, made: dict, seed: int) -> tuple[dict, int]:
    """The checked steps against the reference run from the same weights
    and batches: the first gradient as the optimizer got it (from its state)
    and the parameters' change after the steps, each by the worst leaf, and
    each step's global gradient norm before the clip (relative)."""
    import statistics

    import torch

    from . import weights
    from .reference import train as ref

    cell, mix = rec.cell, rec.cell.traffic
    model = cell.model
    batches = [(b["tokens"], b["labels"]) for b in rec.first.pop("batches")]
    dev = batches[0][0].device

    def start():     # the program's first weights (drawn in its dtype), in float32
        drawn = weights.draw(made["specs"], model, made["weights_seed"], dev, made["dtype"])
        return {k: start_f32(v) for k, v in drawn.items()}

    def start_f32(t):
        return {k: start_f32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()

    tree = start()
    got = ref.train(tree, model, batches, mix["optimizer"])
    before = start()
    change = ref.change_norms(tree, before)
    del tree, before
    # leaves the reference's gradient leaves at rounding (under a thousandth
    # of the median leaf's) move under Adam by round-off alone: left out
    med = statistics.median(got["first_grad"].values())
    still = {n for n, g in got["first_grad"].items() if g < 1e-3 * med}
    rel = lambda p, r: max(abs(a - b) / abs(b) for a, b in zip(p, r))  # noqa: E731
    grad = _gap(rec.first["first_grad"], got["first_grad"])
    moved = _gap(rec.first["change"], change, still)
    lim = cell.limits
    checks = {"first_grad_gap": (grad, lim["first_grad_gap"]["limit"]),
              "change_gap": (moved, lim["change_gap"]["limit"]),
              "grad_norm_gap": (rel(rec.first["grad_norm"], got["grad_norm"]),
                                lim["grad_norm_gap"]["limit"])}
    # read, not compared: no control or fault separates it (PERF.md)
    rec.first["loss_gap"] = rel(rec.first["loss"], got["loss"])
    rec.first["reference"] = {"loss": got["loss"], "grad_norm": got["grad_norm"]}
    return checks, 0 if passed(checks) else mix["check_steps"]


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

DRIVERS = {"serve_closed": (run_serving, check_serving),
           "train": (run_training, check_training)}


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, root: Path = ROOT, cell: Cell | None = None) -> dict:
    """One run of a cell -> the result line's object.  ``device`` None: the
    card, which must be there; a test passes ``"cpu"`` (and may pass a
    smaller ``cell``) to drive the rest of a run."""
    import torch

    marks = {"torch_import": time.perf_counter()}
    cell = cell or find_cell(cell_name, root)
    if device is None:
        require_cuda(cell.entry["chips"])
        device = "cuda:0"
    marks["device_check"] = time.perf_counter()
    drive, check = DRIVERS[cell.traffic["kind"]]
    rec, state = drive(cell, seed, seconds, trace, device, t_start)
    marks.update(rec.setup_marks)
    on_card = torch.device(device).type == "cuda"
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": cell.entry["chips"] if on_card else 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else 0}
    if trace and rec.trace is not None:
        dev_info["busy_s"] = rec.trace.busy_s
        dev_info["window_s"] = rec.trace.window_s
    metrics = {}
    for m in cell.metrics[trace]:
        value = load_reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = check(rec, state, seed)
    out = {"correct": passed(checks), "attempted": rec.attempted, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if trace and rec.trace is not None:
        out["breakdown"] = rec.trace.breakdown()
        out["trace_slice"] = rec.trace.about
    # the set-up's phases (seconds each, in order: the CUDA context is made
    # in "weights"), to see which one a slow set-up spent its time in
    ends = [t_start, *marks.values()]
    out["setup_parts"] = {k: b - a for k, a, b in zip(marks, ends, ends[1:])}
    power = power_limit() if on_card else None
    if power:
        out["card"] = power
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out
