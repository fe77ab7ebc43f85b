"""Real PyTorch executor for task graphs — the StarPU-runtime role.

Executes a :class:`TaskGraph` whose kernels carry real torch callables
(``Kernel.fn``) over named *device groups*, honoring a placement
(kernel -> group) from any scheduling policy.  What StarPU does with worker
threads + MSI, this does with asynchronous CUDA launches + explicit copies:

* data consistency: each data block tracks which groups hold a valid copy
  (write-invalidate, like the paper's StarPU runtime);
* a kernel launched on group g first pulls missing inputs with
  ``tensor.to(device)`` (the PCIe/NVLink transfer — counted, like Fig 5's
  transfer metric);
* CUDA's asynchronous launches give the overlap StarPU gets from worker
  threads; the final device synchronise is the makespan barrier.

Blocks are never written in place.  When several groups alias one device a
pull returns the very same tensor, so an in-place write by one group would
silently change another group's "copy" and break the consistency model.

With a :class:`~repro_torch.core.comm.CommEngine` attached, the session *also*
charges every transfer to the same per-link lane model the simulator uses —
one communication model, two backends.  Each executed kernel gets a virtual
start/finish on a two-resource timeline (per-group compute streams + comm
lanes): compute starts when the group is free AND the inputs' modeled copies
have landed, instead of serializing measured kernel time plus modeled
transfer time on one clock.  Inputs of the next ready kernels are
*prefetched* (a real copy + a ``kind="prefetch"`` lane booking), so
cut-edge transfers hide under the previous kernel's compute.  On a
hierarchical topology every pull books each tier its path crosses (shared
pod uplinks contend) and prefetches are contention-throttled: a deferred
prefetch moves nothing and simply retries at the next step.

Two entry points:

* :meth:`TorchExecutor.run` — one-shot batch execution;
* :class:`ExecSession` — the *online* form: kernels execute one
  :meth:`~ExecSession.step` at a time, the assignment can be rewritten
  between steps (:meth:`~ExecSession.reassign`), per-kernel wall times are
  measured (``time_kernels=True``), and a group that leaves the platform is
  evicted (:meth:`~ExecSession.evict_group`): its block copies are lost and
  any producer whose output a pending consumer still needs is transparently
  re-queued for re-execution — the executor-land analogue of the simulator's
  in-flight abort + re-dispatch on :class:`~repro_torch.core.simulate.WorkerDrop`.
  Prefetched-but-unconsumed copies targeting the dead group are discarded
  from the consistency *and* the comm model, so the consumer's re-pull is
  charged again (the transfer really does happen twice).

Fused super-steps (``fused=True``) and async multi-group waves
(``async_groups=True``) are not ported yet (ROADMAP queue 1, item 1: the
fused path with CUDA graphs and async waves); asking for either raises.

**Streaming pulls** (``streaming=True``, comm attached): demand pulls open
:class:`~repro_torch.core.comm.StreamChannel` s instead of bulk fetches — the
consumer's virtual start gates on the FIRST chunk's arrival and the residual
chunks drain against its compute window (bounded ``stream_depth`` in-flight
chunks = backpressure), while the real copy happens chunk-wise too: the
donor's leading axis is split and copied as depth-bounded asynchronous
copies that reassemble bit-identically on the destination.  Bulk
speculative prefetch is disabled under streaming (channels already overlap
chunk-wise); ``streaming=False`` keeps the bulk path bit-identical.

On one card all groups alias one device (transfers are no-op-counted but
still exercised); on a real machine, groups are disjoint devices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Mapping

import numpy as np
import torch

from .comm import CommEngine

_NOT_PORTED = (
    "{} is not ported yet (ROADMAP queue 1, item 1: the fused path with "
    "CUDA graphs and async waves)"
)


def _sync(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class ExecResult:
    outputs: dict  # block name -> tensor (exit kernels)
    makespan_ms: float
    n_transfers: int
    bytes_transferred: int
    kernels_per_group: dict
    kernel_ms: dict = dataclasses.field(default_factory=dict)
    #                                   # kernel -> wall ms (time_kernels=True)
    reexecuted: list = dataclasses.field(default_factory=list)
    #                                   # kernels re-run after group eviction
    model_makespan_ms: float = 0.0  # two-resource virtual-clock makespan
    lane_busy_ms: dict = dataclasses.field(default_factory=dict)
    n_prefetched: int = 0
    tier_busy_ms: dict = dataclasses.field(default_factory=dict)
    #                                   # wire time per topology tier
    n_throttled: int = 0  # prefetches deferred by the throttle
    n_preempted: int = 0  # in-flight copies cancelled by a group eviction
    fused_steps: int = 0  # compiled group-steps dispatched (fused path)
    cache_hits: int = 0  # super-step cache hits (this session)
    cache_misses: int = 0  # super-step compilations (this session)
    n_streamed: int = 0  # demand pulls executed as chunked channels
    n_stalled_chunks: int = 0  # chunks delayed by channel backpressure
    stream_busy_ms: float = 0.0  # lane time booked by channel chunks
    n_depth_adjust: int = 0  # adaptive prefetch-depth raises/lowers
    n_waves: int = 0  # fused dispatch barriers (fused path)
    overlap_ms: float = 0.0  # virtual compute time co-scheduled inside waves


class SuperStepCache:
    """Persistent compiled-group-step cache.

    Keys are ``(revision, group signature, shapes/dtypes)`` — the revision
    tag comes from the online partitioner (bumped only by full-repartition
    escalations, NOT by boundary-local FM moves or warm ingests), the group
    signature encodes the chain's ops + internal wiring + donation mask, and
    the shape/dtype tuple pins the compiled executable's layout.  A cache
    hit dispatches with nothing to build on the timed path, and a miss
    builds *outside* the timed region.

    The cache assumes the op -> implementation mapping is stable for its
    lifetime (one ``attach`` convention per serving executor): signatures
    name kernel *ops*, not the identity of the attached callables.
    """

    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self._fns: dict = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._fns)

    def clear(self) -> None:
        self._fns.clear()

    def get_or_build(self, key, builder):
        """-> (compiled fn, hit).  ``builder`` runs only on a miss."""
        fn = self._fns.get(key)
        if fn is not None:
            self.hits += 1
            return fn, True
        self.misses += 1
        fn = builder()
        if len(self._fns) >= self.max_entries:  # bounded: drop oldest entry
            self._fns.pop(next(iter(self._fns)))
        self._fns[key] = fn
        return fn, False


@dataclasses.dataclass
class KernelRun:
    """One executed kernel (an :meth:`ExecSession.step` record)."""

    name: str
    group: str
    ms: float  # wall ms (0.0 unless the session times kernels)
    n_transfers: int  # transfers this kernel's input gather caused
    nbytes: int  # bytes those transfers moved
    t_start: float = 0.0  # virtual start (comm model attached)
    t_finish: float = 0.0  # virtual finish (compute + overlapped transfers)


class ExecSession:
    """Incremental execution of a task graph over device groups.

    The session owns the data-consistency state (block -> group -> tensor) and
    executes kernels in dependency order, one per :meth:`step`.  Between steps
    the caller may rewrite placements and apply platform churn — exactly what
    an online scheduling policy needs to co-drive real execution.

    ``comm`` + ``group_nodes`` attach the shared communication model: every
    pull books a lane on the actual src-node -> dst-node link (every crossed
    tier of a hierarchical topology) and kernels get virtual start/finish
    times with transfers overlapping compute (``prefetch_depth`` next-ready
    kernels have their inputs staged early).
    """

    def __init__(
        self,
        executor: "TorchExecutor",
        g,
        assignment: Mapping[str, str],
        inputs: Mapping[str, torch.Tensor] | None = None,
        *,
        host_group: str | None = None,
        time_kernels: bool = False,
        gated: Iterable[str] = (),
        comm: CommEngine | None = None,
        group_nodes: Mapping[str, int] | None = None,
        prefetch_depth: int = 2,
        fused: bool = False,
        cache: SuperStepCache | None = None,
        revision: int = 0,
        streaming: bool = False,
        chunk_bytes: int | None = None,
        stream_depth: int = 2,
        async_groups: bool = False,
    ):
        if fused:
            raise NotImplementedError(_NOT_PORTED.format("fused=True"))
        if async_groups:
            raise NotImplementedError(_NOT_PORTED.format("async_groups=True"))
        g.validate()
        self.ex = executor
        self.g = g
        self.assignment = dict(assignment)
        self.host_group = executor.resolve_host_group(host_group)
        self.time_kernels = time_kernels
        self.cache = cache
        self.revision = revision
        self.fused_steps = 0
        self.cache_hits = 0
        self.cache_misses = 0
        # gated kernels exist in the graph but may not run until admitted
        # (online request streams: the task arrived in the revision but its
        # wall-clock arrival time has not passed yet)
        self.gated: set[str] = set(gated)
        self.comm = comm
        self.group_nodes = dict(group_nodes or {})
        if comm is not None and not self.group_nodes:
            raise ValueError("a comm model needs group_nodes (group -> node)")
        self.prefetch_depth = prefetch_depth if comm is not None else 0
        # streaming: demand pulls open chunked channels instead of bulk
        # fetches — the consumer's virtual start gates on the FIRST chunk and
        # residual arrivals drain against its compute (see comm.StreamChannel);
        # the real copy happens chunk-wise too, depth-bounded
        self.streaming = streaming and comm is not None
        # None -> the topology picks a per-route chunk size (flat topologies
        # return the fixed default, so the resolved value is bit-identical)
        self.chunk_bytes = chunk_bytes
        self.stream_depth = stream_depth
        self.n_waves = 0
        self.overlap_ms = 0.0
        self._pending_channels: list[tuple[str, str, object]] = []
        self._block_window: dict[str, tuple[float, float]] = {}
        self._inputs = dict(inputs or {})
        self.valid: dict[str, dict[str, torch.Tensor]] = {}  # block -> group -> t
        # virtual timeline (comm model): when a block's copy lands per group,
        # when each group's compute stream frees, per-kernel earliest starts
        self.vt_block: dict[tuple[str, str], float] = {}
        self.group_free: dict[str, float] = {}
        self.earliest: dict[str, float] = {}
        self.vnow = 0.0
        self.vmax = 0.0
        self.prefetched: set[tuple[str, str]] = set()
        for name in self._inputs:
            self._seed(name)
        self.n_transfers = 0
        self.nbytes = 0
        self.per_group: dict[str, int] = {}
        self.kernel_ms: dict[str, float] = {}
        self.blocks: dict[str, torch.Tensor] = {}
        self.reexecuted: list[str] = []
        self._order = [n for n in g.topo_order() if g.nodes[n].op != "source"]
        self._done: set[str] = set()
        self._t0 = time.perf_counter()

    # -- state ---------------------------------------------------------------

    def _node_of(self, group: str) -> int:
        return self.group_nodes.get(group, 0)

    def _seed(self, block: str) -> None:
        """(Re-)materialize a host-resident input block on the host group."""
        dev = self.ex.groups[self.host_group]
        self.valid[block] = {self.host_group: self._inputs[block].to(dev)}
        self.vt_block[(block, self.host_group)] = 0.0

    def pending(self) -> list[str]:
        return [n for n in self._order if n not in self._done]

    def done(self) -> bool:
        return len(self._done) == len(self._order)

    def reassign(self, mapping: Mapping[str, str]) -> None:
        """Rewrite placements for not-yet-executed kernels (policy refresh)."""
        self.assignment.update(mapping)

    def admit(self, names, at: float | None = None) -> None:
        """Lift the arrival gate from ``names`` (they become schedulable as
        soon as their dependencies are satisfied).  ``at`` floors their
        virtual start at the admitting stream clock."""
        names = list(names)
        self.gated.difference_update(names)
        if at is not None:
            for n in names:
                self.earliest[n] = max(self.earliest.get(n, 0.0), at)

    def next_ready(self) -> str | None:
        for n in self._order:
            if n in self._done or n in self.gated:
                continue
            if all(
                p in self._done or self.g.nodes[p].op == "source"
                for p in self.g.predecessors(n)
            ):
                return n
        return None

    def _ready_next(self, count: int) -> list[str]:
        """Up to ``count`` currently-ready kernels (prefetch targets)."""
        out: list[str] = []
        for n in self._order:
            if n in self._done or n in self.gated:
                continue
            if all(
                p in self._done or self.g.nodes[p].op == "source"
                for p in self.g.predecessors(n)
            ):
                out.append(n)
                if len(out) >= count:
                    break
        return out

    # -- eviction (worker-drop recovery) ---------------------------------------

    def _requeue(self, name: str) -> None:
        if name not in self._done:
            return
        self._done.discard(name)
        self.reexecuted.append(name)
        for p in self.g.predecessors(name):
            if self.g.nodes[p].op != "source" and p not in self.valid:
                self._requeue(p)

    def evict_group(self, group: str) -> list[str]:
        """Group memory is gone (worker drop): invalidate its block copies.

        A block whose *last* copy lived there is lost; host input blocks are
        re-seeded from the caller's tensors, while kernel outputs still needed
        by a pending consumer force their producer (transitively) back onto
        the queue.  Prefetched-but-unconsumed copies on the dead group are
        discarded from the comm model too, so the consumer's re-pull books a
        fresh transfer instead of riding a phantom one.  Copies still in
        flight toward the dead group's memory node are preempted on the comm
        engine — their remaining lane time is released and they count toward
        ``n_preempted``.  Returns the kernels re-queued for re-execution."""
        if self.comm is not None:
            node = self._node_of(group)
            if not any(
                self._node_of(g) == node for g in self.group_nodes if g != group
            ):
                self.comm.preempt_dst(node, self.vnow)
        for block, grp in list(self.vt_block):
            if grp == group:
                del self.vt_block[(block, grp)]
        for block, grp in list(self.prefetched):
            if grp == group:
                self.prefetched.discard((block, grp))
        if self._pending_channels:
            # undrained channels toward the dead group die with it (their
            # booked chunk-0 segments are released by preempt_dst above)
            self._pending_channels = [
                c for c in self._pending_channels if c[1] != group
            ]
        lost: list[str] = []
        for block, ent in list(self.valid.items()):
            if ent.pop(group, None) is not None and not ent:
                del self.valid[block]
                lost.append(block)
        before = len(self.reexecuted)
        for block in lost:
            if block in self._inputs:
                self._seed(block)
            elif block in self.g.nodes and any(
                s not in self._done for s in self.g.successors(block)
            ):
                self._requeue(block)
        return self.reexecuted[before:]

    # -- execution -------------------------------------------------------------

    def _input_keys(self, name: str) -> list[tuple[str, int]]:
        """(block key, byte count) for every input of ``name``."""
        out: list[tuple[str, int]] = []
        preds = self.g.predecessors(name)
        if not preds and f"{name}/in" in self.valid:
            out.append((f"{name}/in", 0))  # source-less entry kernel
        for pred in preds:
            # entry kernels read their seeded "<kernel>/in" block
            if self.g.nodes[pred].op == "source":
                out.append((name + "/in", 0))
            else:
                out.append((pred, self.g.edge(pred, name).nbytes))
        return out

    def _pull(
        self, key: str, nbytes: int, grp: str, dev, kind: str, now: float | None = None
    ) -> int:
        """Copy ``key`` onto ``grp`` if missing; returns bytes moved (0 when
        already valid there, or when the contention throttle deferred a
        prefetch — the lanes are booked *before* the real copy, so a
        throttled prefetch costs nothing and retries later).  ``now``
        overrides the booking clock."""
        ent = self.valid.get(key)
        if ent is None or grp in ent:
            return 0
        if self.comm is not None:
            donor_grp = min(ent, key=lambda g: (self.vt_block.get((key, g), 0.0), g))
        else:
            donor_grp = next(iter(ent))
        donor = ent[donor_grp]
        nb = nbytes or donor.numel() * donor.element_size()
        t_now = self.vnow if now is None else now
        if self.streaming and kind == "demand":
            win = self._block_window.get(key)
            src_ready = self.vt_block.get((key, donor_grp), 0.0)
            # pro-rata chunk readiness only when the donor copy IS the
            # producer's own output (its compute window ends at src_ready)
            src_start = (
                win[0] if win is not None and abs(win[1] - src_ready) <= 1e-9 else None
            )
            ch = self.comm.open_stream(
                key,
                self._node_of(donor_grp),
                self._node_of(grp),
                nb,
                now=t_now,
                src_start=src_start,
                src_ready=src_ready,
                chunk_bytes=self.chunk_bytes,
                depth=self.stream_depth,
            )
            if ch is not None:
                # provisional: chunk-0 arrival gates the consumer's start;
                # drain() (post-dispatch) rewrites it to the last arrival
                self.vt_block[(key, grp)] = ch.first_ready
                self._pending_channels.append((key, grp, ch))
                ent[grp] = self._stream_put(donor, dev, ch.n_chunks)
                return nb
            # same node: no wire — fall through to the free bulk path
        if self.comm is not None:
            src_ready = self.vt_block.get((key, donor_grp), 0.0)
            te = self.comm.fetch(
                key,
                self._node_of(donor_grp),
                self._node_of(grp),
                nb,
                now=t_now,
                src_ready=src_ready,
                kind=kind,
            )
            if te is None:  # throttled prefetch: nothing moved
                return 0
            self.vt_block[(key, grp)] = te
            if kind == "prefetch":
                self.prefetched.add((key, grp))
        ent[grp] = donor.to(dev)
        return nb

    def _stream_put(self, donor: torch.Tensor, dev, n_chunks: int) -> torch.Tensor:
        """Chunk-wise copy: the donor's leading axis is split into up to
        ``n_chunks`` slices copied separately, with at most ``stream_depth``
        CUDA copies in flight (the real-transfer analogue of the channel's
        bounded depth); the slices reassemble bit-identically on the
        destination device."""
        if n_chunks <= 1 or donor.dim() == 0 or donor.shape[0] < 2:
            return donor.to(dev)
        rows = donor.shape[0]
        step = -(-rows // min(n_chunks, rows))
        parts: list[torch.Tensor] = []
        landed: list[torch.cuda.Event] = []
        for part in donor.split(step, dim=0):
            parts.append(part.to(dev))
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                landed.append(ev)
                if self.stream_depth and len(landed) > self.stream_depth:
                    landed[-self.stream_depth - 1].synchronize()
        return torch.cat(parts, dim=0)

    def _drain_channels(self, vstart: float, ms: float, vfinish: float) -> float:
        """Drain every channel opened for the kernel just dispatched against
        its compute window; returns the extended virtual finish (a consumer
        cannot retire before its last chunk arrives AND is consumed)."""
        for key, grp, ch in self._pending_channels:
            ch_finish, arrival_last = ch.drain(vstart, ms)
            vfinish = max(vfinish, ch_finish)
            self.vt_block[(key, grp)] = arrival_last
        self._pending_channels.clear()
        return vfinish

    def _gather(self, name: str, grp: str, dev) -> tuple[list, int, int, float]:
        """Pull input blocks for ``name`` onto ``grp``.
        Returns (args, n_transfers, nbytes, inputs-ready virtual time)."""
        args: list[torch.Tensor] = []
        nt = nb = 0
        ready_vt = 0.0
        for key, nbytes in self._input_keys(name):
            ent = self.valid.get(key)
            if ent is None:
                continue
            moved = self._pull(key, nbytes, grp, dev, "demand")
            if moved:
                nt += 1
                nb += moved
            self.prefetched.discard((key, grp))
            ready_vt = max(ready_vt, self.vt_block.get((key, grp), 0.0))
            args.append(ent[grp])
        return args, nt, nb, ready_vt

    def _prefetch_ready(self) -> None:
        """Stage inputs of the next ready kernels onto their assigned groups
        while "now" is still this kernel's finish — the staged copies ride
        comm lanes under the next kernels' compute."""
        if self.comm is None or self.prefetch_depth <= 0:
            return
        if self.streaming:
            return  # channels already overlap chunk-wise; no bulk speculation
        for n in self._ready_next(self.prefetch_depth):
            grp = self.assignment.get(n, self.host_group)
            dev = self.ex.groups[grp]
            for key, nbytes in self._input_keys(n):
                moved = self._pull(key, nbytes, grp, dev, "prefetch")
                if moved:
                    self.n_transfers += 1
                    self.nbytes += moved

    def step(self) -> KernelRun | None:
        """Execute the next ready kernel; ``None`` when the graph is drained.

        With ``time_kernels`` the kernel's wall time is bracketed by two
        synchronises of its group's device, so it covers the kernel's run on
        the card and not just its launch; the first synchronise (inputs
        ready) lies outside the timed region."""
        name = self.next_ready()
        if name is None:
            return None
        k = self.g.nodes[name]
        grp = self.assignment.get(name, self.host_group)
        dev = self.ex.groups[grp]
        args, nt, nb, ready_vt = self._gather(name, grp, dev)
        self.n_transfers += nt
        self.nbytes += nb
        if k.fn is None:
            raise ValueError(f"kernel {name} has no fn")
        ms = 0.0
        if self.time_kernels:
            _sync(dev)
            t0 = time.perf_counter()
        out = k.fn(*args)
        if self.time_kernels:
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            self.kernel_ms[name] = ms
        vstart = vfinish = 0.0
        if self.comm is not None:
            vstart = max(
                self.group_free.get(grp, 0.0), ready_vt, self.earliest.get(name, 0.0)
            )
            vfinish = vstart + ms
            if self._pending_channels:
                vfinish = self._drain_channels(vstart, ms, vfinish)
            self.group_free[grp] = vfinish
            self.vnow = vfinish
            self.vmax = max(self.vmax, vfinish)
            self.vt_block[(name, grp)] = vfinish
            self._block_window[name] = (vstart, vfinish)
        self.valid[name] = {grp: out}
        self.blocks[name] = out
        self.per_group[grp] = self.per_group.get(grp, 0) + 1
        self._done.add(name)
        self._prefetch_ready()
        return KernelRun(name, grp, ms, nt, nb, vstart, vfinish)

    def run_all(self) -> None:
        while self.step() is not None:
            pass

    def result(self) -> ExecResult:
        outs = {n: self.blocks[n] for n in self.g.exit_nodes() if n in self.blocks}
        for dev in {t.device for t in outs.values()}:
            _sync(dev)
        dt = (time.perf_counter() - self._t0) * 1e3
        return ExecResult(
            outputs=outs,
            makespan_ms=dt,
            n_transfers=self.n_transfers,
            bytes_transferred=self.nbytes,
            kernels_per_group=self.per_group,
            kernel_ms=dict(self.kernel_ms),
            reexecuted=list(self.reexecuted),
            model_makespan_ms=self.vmax,
            lane_busy_ms=self.comm.lane_busy_ms() if self.comm else {},
            n_prefetched=self.comm.n_prefetched if self.comm else 0,
            tier_busy_ms=self.comm.tier_busy_ms() if self.comm else {},
            n_throttled=self.comm.n_throttled if self.comm else 0,
            n_preempted=self.comm.n_preempted if self.comm else 0,
            fused_steps=self.fused_steps,
            cache_hits=self.cache_hits,
            cache_misses=self.cache_misses,
            n_streamed=self.comm.n_streamed if self.comm else 0,
            n_stalled_chunks=self.comm.n_stalled_chunks if self.comm else 0,
            stream_busy_ms=self.comm.stream_busy_ms if self.comm else 0.0,
            n_depth_adjust=self.comm.n_depth_adjust if self.comm else 0,
            n_waves=self.n_waves,
            overlap_ms=self.overlap_ms,
        )


class TorchExecutor:
    def __init__(self, groups: Mapping[str, torch.device]):
        """groups: group name -> the torch device that group runs on."""
        self.groups = {name: torch.device(d) for name, d in groups.items()}

    def resolve_host_group(self, host_group: str | None = None) -> str:
        """The group seeding host-resident inputs.  Defaults to the
        lexicographically-first group name so multi-group placements never
        depend on dict insertion order."""
        if host_group is None:
            return min(self.groups)
        if host_group not in self.groups:
            raise KeyError(f"unknown host group {host_group!r}")
        return host_group

    def session(
        self,
        g,
        assignment: Mapping[str, str],
        inputs: Mapping[str, torch.Tensor] | None = None,
        **kw,
    ) -> ExecSession:
        """An :class:`ExecSession` over this executor's groups; keyword
        arguments are :class:`ExecSession`'s."""
        return ExecSession(self, g, assignment, inputs, **kw)

    def run(
        self,
        g,
        assignment: Mapping[str, str],
        inputs: Mapping[str, torch.Tensor] | None = None,
        *,
        host_group: str | None = None,
        time_kernels: bool = False,
    ) -> ExecResult:
        """assignment: kernel -> group name.  ``inputs`` seeds the source
        blocks (host-resident, like the paper's initial data) on
        ``host_group`` (explicit, or the deterministic default)."""
        s = self.session(
            g, assignment, inputs, host_group=host_group, time_kernels=time_kernels
        )
        s.run_all()
        return s.result()


def _dtype_of(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _attach_kernels(g, n: int, fns: Mapping, dtype, seed: int) -> dict:
    """Attach real implementations from ``fns`` (op -> callable) to every
    kernel and seed a ``<kernel>/in`` host input block for each entry kernel
    (one fed by the virtual source, or one with no predecessors at all).
    Inputs are drawn on the host from a ``torch.Generator`` seeded with
    ``seed``.  Returns the inputs dict for :meth:`TorchExecutor.run`."""
    gen = torch.Generator().manual_seed(seed)
    inputs = {}
    for name, k in g.nodes.items():
        if k.op == "source":
            continue
        if k.op not in fns:
            raise KeyError(
                f"kernel {name!r} has op {k.op!r} without an "
                f"implementation (have {sorted(fns)})"
            )
        k.fn = fns[k.op]
        preds = g.predecessors(name)
        if not preds or any(g.nodes[p].op == "source" for p in preds):
            x = torch.randn((n, n), generator=gen, dtype=torch.float32)
            inputs[name + "/in"] = x.to(_dtype_of(dtype))
    return inputs


def inputs_from_numpy(arrays: Mapping[str, object], device) -> dict:
    """Carry host arrays over as tensors on ``device`` (the reference's
    ``attach_*_kernels`` inputs, converted with ``np.asarray``): the same
    bits, including bfloat16, which numpy holds as ``ml_dtypes.bfloat16``."""
    out = {}
    for name, arr in arrays.items():
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        out[name] = t.to(device)
    return out


def attach_matrix_kernels(g, n: int, dtype="float32") -> dict:
    """The paper's MA/MM kernels (via kernels/ops.py) as real fns."""
    from ..kernels import ops

    fns = {
        "matmul": lambda *xs: ops.matmul(xs[0], xs[1] if len(xs) > 1 else xs[0]),
        "matadd": lambda *xs: ops.matadd(xs[0], xs[1] if len(xs) > 1 else xs[0]),
    }
    return _attach_kernels(g, n, fns, dtype, seed=0)


def attach_request_kernels(g, n: int, dtype="float32") -> dict:
    """Real implementations for the serving request-chain DAGs
    (:func:`repro_torch.core.arena.make_request_stream`): ``prefill`` is the
    compute-heavy matmul, ``decode`` the bandwidth-bound matadd — mirroring
    the cost-table asymmetry the scheduler reasons about."""
    from ..kernels import ops

    fns = {
        "prefill": lambda *xs: ops.matmul(xs[0], xs[0].T if len(xs) < 2 else xs[1]),
        "decode": lambda *xs: ops.matadd(xs[0], xs[1] if len(xs) > 1 else xs[0]),
    }
    return _attach_kernels(g, n, fns, dtype, seed=1)
