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

**Fused super-steps** (``fused=True``): instead of the kernel-at-a-time
loop — one launch plus (with ``time_kernels``) two device synchronises *per
kernel* — the session assembles each partition group's currently-runnable
intra-group kernel chain (:func:`repro_torch.kernels.ops.build_chain`
composed per the graph's topological order) and runs it as ONE step with one
ready-barrier per group-step.  On a CUDA group the chain is captured once
into a CUDA graph over static input buffers and replayed
(:class:`~repro_torch.kernels.graphs.CapturedChain`); on a CPU group, where
CUDA graphs do not exist, it is called as it is.  Per-kernel wall times are
*apportioned* from the fused wall time by the kernels' cost-table weights,
so the measured-cost / EWMA feedback loop keeps working.  Captured
group-steps live in a persistent :class:`SuperStepCache` keyed by (graph
revision, group signature, input shapes/dtypes): an online re-partition only
re-captures the groups whose membership actually changed, and a
full-repartition escalation (a new revision tag) invalidates everything.
Torch has no buffer donation; a dead external input whose only copy lives
on the group (the reference's donation rule) is dropped from the
consistency state once the chain has read it, and recorded as donated.

**Async multi-group waves** (``async_groups=True``, with ``fused``): every
group with a runnable chain dispatches in the same dependency wave.  On the
card each group's chain replays on its own CUDA stream (even when every
group aliases one card): the group streams wait on an event of the current
stream before the wave and the current stream waits on each group's event
after it, so cross-group inputs are ordered by events, and a timed wave ends
with one device synchronise.  Cross-group pulls are booked at the
consumer's own gate (:meth:`CommEngine.fetch_async`), not the previous
group-step's finish.

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

from ..kernels.graphs import CapturedChain, EagerChain
from ..kernels.ops import build_chain
from .comm import CommEngine


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
    n_waves: int = 0  # fused dispatch barriers (== fused_steps serialized;
    #                                   # fewer with async_groups wave overlap)
    overlap_ms: float = 0.0  # virtual compute time co-scheduled inside waves
    #                                   # (sum of member spans minus wave span)
    static_copies: int = 0  # external inputs copied into CUDA graphs' buffers
    static_copy_bytes: int = 0  # their bytes


@dataclasses.dataclass
class SuperStepRun:
    """One fused group-step: a whole intra-group kernel chain run as a
    single captured graph replay (audit record for apportionment /
    donation)."""

    group: str
    members: list  # kernel names, chain order
    ms: float  # fused wall ms (one barrier for the whole chain)
    cache_hit: bool
    donated: list  # dead external input blocks dropped after the chain read them
    n_transfers: int
    nbytes: int


class SuperStepCache:
    """Persistent captured-group-step cache.

    Keys are ``(revision, group signature, shapes/dtypes)`` — the revision
    tag comes from the online partitioner (bumped only by full-repartition
    escalations, NOT by boundary-local FM moves or warm ingests), the group
    signature encodes the chain's ops + internal wiring + donation mask, and
    the shape/dtype tuple pins the captured graph's buffers.  A cache hit
    replays with nothing to capture on the timed path, and a miss captures
    *outside* the timed region.  Entries have a ``release()`` method (a
    :class:`~repro_torch.kernels.graphs.CapturedChain` frees its CUDA graph
    and memory pool there).  Eviction is FIFO, as in the reference, so a
    wave's miss may evict the entry an earlier plan of the same wave has
    just looked up and not yet replayed.  The reference only drops a
    reference there; releasing a graph would break that replay.  So an
    evicted entry is released by :meth:`release_dropped`, which the session
    calls once the group-step or wave has replayed, and by :meth:`clear`.

    The cache assumes the op -> implementation mapping is stable for its
    lifetime (one ``attach`` convention per serving executor): signatures
    name kernel *ops*, not the identity of the attached callables.
    """

    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self._fns: dict = {}
        self._dropped: list = []  # evicted, released after the running wave
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._fns)

    def clear(self) -> None:
        self.release_dropped()
        for fn in self._fns.values():
            fn.release()
        self._fns.clear()

    def release_dropped(self) -> None:
        """Release the entries evicted since the last call."""
        for fn in self._dropped:
            fn.release()
        self._dropped.clear()

    def get_or_build(self, key, builder):
        """-> (entry, hit).  ``builder`` runs only on a miss."""
        fn = self._fns.get(key)
        if fn is not None:
            self.hits += 1
            return fn, True
        self.misses += 1
        fn = builder()
        if len(self._fns) >= self.max_entries:  # bounded: drop oldest entry
            self._dropped.append(self._fns.pop(next(iter(self._fns))))
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
        cost_clock: bool = False,
    ):
        g.validate()
        self.ex = executor
        self.g = g
        self.assignment = dict(assignment)
        self.host_group = executor.resolve_host_group(host_group)
        self.time_kernels = time_kernels
        self.fused = fused
        self.cache = (
            cache if cache is not None else (SuperStepCache() if fused else None)
        )
        self.revision = revision
        self.fused_steps = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.static_copies = 0
        self.static_copy_bytes = 0
        self.superstep_runs: list[SuperStepRun] = []
        self._fused_buf: list[KernelRun] = []
        # op -> kernels executed, re-runs included; beside the step records
        # it also counts a fused member whose record an eviction dropped
        self.kernels_by_op: dict[str, int] = {}
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
        # async_groups: fused dispatch happens in dependency WAVES — every
        # group with a runnable chain launches in the same wave (one barrier
        # per wave, not per group) and cross-group pulls are booked at the
        # consumer's own gate instead of the previous group-step's finish
        self.async_groups = async_groups and fused
        # cost_clock: with time_kernels off, drive the virtual timeline from
        # the cost table instead of zero-width kernels — deterministic model
        # makespans for benches and simulator-agreement checks (fused paths)
        self.cost_clock = cost_clock
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
        if self._fused_buf:
            # an already-executed-but-unreported member whose kernel was just
            # re-queued will run (and be reported) again: drop its stale record
            self._fused_buf = [r for r in self._fused_buf if r.name in self._done]
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
            if self.async_groups and kind == "demand":
                # non-blocking pull: the booking happens now, completion is
                # charged to the lanes, and the handle's ETA (not a barrier)
                # gates the consumer's admission into its wave
                te = self.comm.fetch_async(
                    key,
                    self._node_of(donor_grp),
                    self._node_of(grp),
                    nb,
                    now=t_now,
                    src_ready=src_ready,
                    kind=kind,
                ).eta
            else:
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

    # -- fused super-steps -----------------------------------------------------

    def _plan_chain(self, claimed=()) -> dict | None:
        """The maximal runnable intra-group chain of the first group with
        ready work, skipping the groups in ``claimed``; ``None`` when there
        is none.

        The first ready kernel (what :meth:`next_ready` would return, among
        unclaimed groups) anchors the chain and fixes the group; every later
        not-done, not-gated kernel of that group whose predecessors are all
        finished or earlier chain members joins it.  Each member's
        predecessors are classified in the same pass: an ``int`` entry is an
        intra-chain slot, a ``(key, nbytes)`` entry an external block."""
        done = self._done
        gated = self.gated
        g_nodes = self.g.nodes
        predecessors = self.g.predecessors
        get_group = self.assignment.get
        host = self.host_group
        grp: str | None = None
        members: list[str] = []
        midx: dict[str, int] = {}
        fns: list = []
        ops: list[str] = []
        costs: list[float] = []
        entries: list[list] = []
        for n in self._order:
            if n in done or n in gated:
                continue
            n_grp = get_group(n, host)
            if n_grp in claimed or (grp is not None and n_grp != grp):
                continue
            preds = predecessors(n)
            entry: list = []
            runnable = True
            for p in preds:
                j = midx.get(p)
                if j is not None:
                    entry.append(j)
                elif g_nodes[p].op == "source":
                    entry.append((n + "/in", 0))  # entry kernel: seeded input
                elif p in done:
                    entry.append((p, self.g.edge(p, n).nbytes))
                else:
                    runnable = False
                    break
            if not runnable:
                continue
            if not preds and (n + "/in") in self.valid:
                entry.append((n + "/in", 0))  # source-less entry kernel
            k = g_nodes[n]
            if k.fn is None:
                raise ValueError(f"kernel {n} has no fn")
            if grp is None:
                grp = n_grp
            midx[n] = len(members)
            members.append(n)
            fns.append(k.fn)
            ops.append(k.op)
            costs.append(k.costs.get(grp, 0.0))
            entries.append(entry)
        if grp is None:
            return None
        return dict(grp=grp, dev=self.ex.groups[grp], members=members, midx=midx,
                    fns=fns, ops=ops, costs=costs, entries=entries)

    def _donatable(self, key: str, grp: str, member_set) -> bool:
        """May the group's copy of ``key`` be donated to the fused step?
        Only when it is dead afterwards: not a caller-owned seed (re-seeding
        reads it), not an exit output, the group's copy is the ONLY one (a
        sibling group may alias the same physical tensor on a shared
        device), and every not-yet-finished consumer is inside the chain."""
        if key in self._inputs:
            return False
        ent = self.valid.get(key)
        if ent is None or set(ent) != {grp}:
            return False
        if key in self.g.nodes:
            if not self.g.successors(key):
                return False  # exit output: result() must return it
            return all(
                s in self._done or s in member_set for s in self.g.successors(key)
            )
        return False

    def _gather_chain(self, pl: dict, wave: bool) -> None:
        """Pull a planned chain's external inputs onto its group once (demand
        pulls book comm lanes exactly as the unfused path would, attributed
        to the first needing kernel) and pick which outputs to materialize.
        ``wave``: pulls are booked at the consumer's own gate (its group's
        free time / admission floor), not the previous group-step's finish."""
        grp, dev = pl["grp"], pl["dev"]
        member_set = pl["midx"].keys()
        valid = self.valid
        done = self._done
        successors = self.g.successors
        pend = self._pending_channels
        gate = self.group_free.get(grp, 0.0)
        ext_keys: list[str] = []
        ext_index: dict[str, int] = {}
        plan: list[tuple] = []
        per_nt: list[int] = []
        per_nb: list[int] = []
        ready_vt: list[float] = []
        keep: list[int] = []
        out_slot: dict[str, int] = {}
        member_chans: list[list] = []  # channels attributed to each member
        total_nt = total_nb = 0
        for i, n in enumerate(pl["members"]):
            srcs: list[tuple[str, int]] = []
            rv = 0.0
            nt = nb = 0
            nch0 = len(pend)
            for item in pl["entries"][i]:
                if type(item) is int:
                    srcs.append(("mem", item))
                    continue
                key, nbytes = item
                if key not in valid:
                    continue  # same skip as _gather on a missing block
                e = ext_index.get(key)
                if e is None:
                    now = max(gate, self.earliest.get(n, 0.0)) if wave else None
                    moved = self._pull(key, nbytes, grp, dev, "demand", now=now)
                    if moved:
                        nt += 1
                        nb += moved
                    self.prefetched.discard((key, grp))
                    e = ext_index[key] = len(ext_keys)
                    ext_keys.append(key)
                srcs.append(("ext", e))
                rv = max(rv, self.vt_block.get((key, grp), 0.0))
            plan.append((pl["ops"][i], tuple(srcs)))
            per_nt.append(nt)
            per_nb.append(nb)
            total_nt += nt
            total_nb += nb
            ready_vt.append(rv)
            # materialize only LIVE outputs — exits, or blocks a kernel
            # outside this chain still needs; dead intermediates stay inside
            # the captured graph's pool
            succs = successors(n)
            if not succs or any(s not in done and s not in member_set for s in succs):
                out_slot[n] = len(keep)
                keep.append(i)
            member_chans.append(pend[nch0:])
        pend.clear()
        self.n_transfers += total_nt
        self.nbytes += total_nb
        pl.update(plan=plan, per_nt=per_nt, per_nb=per_nb, ready_vt=ready_vt, keep=keep,
                  out_slot=out_slot, ext_keys=ext_keys, member_chans=member_chans,
                  total_nt=total_nt, total_nb=total_nb)

    def _look_up(self, pl: dict) -> None:
        """Find (or capture) the chain's cache entry under the reference's
        signature: revision, group, plan, kept outputs, the externals'
        shapes and dtypes, and the donation mask.  A miss on a CUDA group
        captures a CUDA graph over static buffers; on a CPU group the chain
        is called as it is.  Hits and misses are counted alike."""
        grp, dev = pl["grp"], pl["dev"]
        ext_args = [self.valid[key][grp] for key in pl["ext_keys"]]
        member_set = pl["midx"].keys()
        donate = tuple(
            i for i, key in enumerate(pl["ext_keys"])
            if self._donatable(key, grp, member_set)
        )
        sig = (
            self.revision,
            grp,
            tuple(pl["plan"]),
            tuple(pl["keep"]),
            tuple((tuple(a.shape), a.dtype) for a in ext_args),
            donate,
        )

        def build():
            chain = build_chain(
                [(fn, srcs) for fn, (_, srcs) in zip(pl["fns"], pl["plan"])], pl["keep"]
            )
            if dev.type == "cuda":
                return CapturedChain(chain, ext_args, dev)
            return EagerChain(chain)

        fn, hit = self.cache.get_or_build(sig, build)
        self.cache_hits += int(hit)
        self.cache_misses += int(not hit)
        pl.update(fn=fn, hit=hit, ext_args=ext_args, donate=donate)

    def _replay(self, pl: dict, stream=None) -> None:
        """Run the chain's entry on its group (on ``stream`` when given): a
        graph replay on the card, whose external inputs are copied into the
        graph's static buffers first, or the chain itself on the CPU."""
        fn, ext_args = pl["fn"], pl["ext_args"]
        if isinstance(fn, CapturedChain):
            self.static_copies += len(ext_args)
            self.static_copy_bytes += sum(a.numel() * a.element_size() for a in ext_args)
        if stream is None:
            pl["outs"] = fn.replay(ext_args)
            return
        with torch.cuda.stream(stream):
            for a in ext_args:
                a.record_stream(stream)  # read here, maybe freed from another stream
            pl["outs"] = fn.replay(ext_args)

    def _retire_chain(self, pl: dict, member_ms, record: bool, wave: bool) -> float:
        """Drop the chain's donated external copies, then retire its members
        in order: apportioned (or cost-clock) times, virtual start/finish,
        materialized outputs, per-kernel records.  Returns the sum of the
        members' virtual spans (for a wave's overlap account)."""
        grp = pl["grp"]
        valid, vt_block, comm = self.valid, self.vt_block, self.comm
        # donated external inputs are consumed: drop the group's copies
        donated = [pl["ext_keys"][i] for i in pl["donate"]]
        for key in donated:
            ent = valid.get(key)
            if ent is not None:
                ent.pop(grp, None)
                if not ent:
                    del valid[key]
            vt_block.pop((key, grp), None)
        outs = pl["outs"]
        busy = 0.0
        chain_ms = 0.0
        for i, n in enumerate(pl["members"]):
            kms = member_ms[i]
            chain_ms += kms
            if self.time_kernels:
                self.kernel_ms[n] = kms
            vstart = vfinish = 0.0
            if comm is not None:
                vstart = max(
                    self.group_free.get(grp, 0.0),
                    pl["ready_vt"][i],
                    self.earliest.get(n, 0.0),
                )
                vfinish = vstart + kms
                for key, cgrp, ch in pl["member_chans"][i]:
                    ch_finish, arrival_last = ch.drain(vstart, kms)
                    vfinish = max(vfinish, ch_finish)
                    vt_block[(key, cgrp)] = arrival_last
                self.group_free[grp] = vfinish
                if not wave:
                    self.vnow = vfinish
                self.vmax = max(self.vmax, vfinish)
                self._block_window[n] = (vstart, vfinish)
                pl["lo"] = vstart if pl.get("lo") is None else min(pl["lo"], vstart)
                pl["hi"] = max(pl.get("hi", 0.0), vfinish)
                busy += vfinish - vstart
            slot = pl["out_slot"].get(n)
            if slot is not None:
                out = outs[slot]
                valid[n] = {grp: out}
                self.blocks[n] = out
                if comm is not None:
                    vt_block[(n, grp)] = vfinish
            self._done.add(n)
            op = pl["ops"][i]
            self.kernels_by_op[op] = self.kernels_by_op.get(op, 0) + 1
            if record:
                self._fused_buf.append(
                    KernelRun(n, grp, kms, pl["per_nt"][i], pl["per_nb"][i], vstart, vfinish)
                )
        self.per_group[grp] = self.per_group.get(grp, 0) + len(pl["members"])
        self.fused_steps += 1
        self.superstep_runs.append(
            SuperStepRun(grp, pl["members"], pl["ms"] if not wave else chain_ms, pl["hit"],
                         donated, pl["total_nt"], pl["total_nb"])
        )
        return busy

    def _member_ms(self, costs: list[float], wall_ms: float) -> list[float]:
        """Each member's share of ``wall_ms`` by cost-table weight (equal
        shares when no member has a positive cost), or its cost itself under
        ``cost_clock`` with ``time_kernels`` off — so MeasuredCostModel.observe
        / EWMA feedback keeps working per kernel."""
        if self.cost_clock and not self.time_kernels:
            return list(costs)
        weights = [c if c > 0.0 else 0.0 for c in costs]
        wsum = sum(weights)
        if wsum <= 0.0:
            weights = [1.0] * len(costs)
            wsum = float(len(costs))
        return [wall_ms * w / wsum for w in weights]

    def _fused_superstep(self, record: bool = True) -> bool:
        """Plan + dispatch one captured group-step; with ``record`` it fills
        ``_fused_buf`` with per-kernel records (the :meth:`step` replay
        queue; :meth:`run_all` skips them).  False when nothing is ready."""
        pl = self._plan_chain()
        if pl is None:
            return False
        self._gather_chain(pl, wave=False)
        self._look_up(pl)
        dev = pl["dev"]
        ms = 0.0
        if self.time_kernels:
            # ONE synchronise before the group-step, outside the timed
            # region: input production must not leak into the apportioned
            # kernel times
            _sync(dev)
            t0 = time.perf_counter()
        self._replay(pl)
        if self.time_kernels:
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
        pl["ms"] = ms
        self.cache.release_dropped()
        self._retire_chain(pl, self._member_ms(pl["costs"], ms), record, wave=False)
        self.n_waves += 1  # serialized dispatch: every group-step is a barrier
        self._prefetch_ready()
        return True

    def _fused_wave(self, record: bool = True) -> bool:
        """Plan + dispatch one dependency WAVE: every group with a runnable
        intra-group chain launches its fused step in the same round — one
        synchronise for the whole wave instead of one per group, so the
        card runs independent groups' chains concurrently (each on its
        group's stream).

        Wave membership repeats the :meth:`_plan_chain` scan once per
        still-unplanned group; a kernel whose predecessor sits in *another*
        chain of this wave is not runnable yet and joins a later wave, so
        chains are mutually independent by construction and waves are
        exactly the topological levels of the quotient (group) DAG.  Each
        chain's cross-group pulls are issued non-blocking at the consumer's
        own gate (``_pull(now=...)`` + :meth:`CommEngine.fetch_async`), and
        its virtual start floors at the last pull's ETA.  The wave wall is
        apportioned to ALL wave members by cost weight so
        ``MeasuredCostModel`` feedback survives; False when nothing is
        ready."""
        plans: list[dict] = []
        claimed: set[str] = set()
        while (pl := self._plan_chain(claimed)) is not None:
            claimed.add(pl["grp"])
            plans.append(pl)
        if not plans:
            return False
        consumers: dict[str, set[str]] = {}  # ext key -> pulling wave chains
        for pl in plans:
            self._gather_chain(pl, wave=True)
            for key in pl["ext_keys"]:
                consumers.setdefault(key, set()).add(pl["grp"])
        self._seal_wave(plans, consumers)
        for pl in plans:
            self._look_up(pl)

        devs = {pl["dev"] for pl in plans}
        tk = self.time_kernels
        wave_ms = 0.0
        if tk:
            for dev in devs:  # outside the timed region, as in a group-step
                _sync(dev)
            t0 = time.perf_counter()
        # each CUDA group replays on its own stream: the streams wait on the
        # current stream's work (seeds, pulls, earlier waves) and the
        # current stream waits on each of them, so a block made on one
        # group's stream is read on another's only after an event
        fork = {d: torch.cuda.current_stream(d).record_event()
                for d in devs if d.type == "cuda"}
        joins = []
        for pl in plans:
            dev = pl["dev"]
            if dev.type != "cuda":
                self._replay(pl)
                continue
            stream = self.ex.stream_of(pl["grp"])
            stream.wait_event(fork[dev])
            self._replay(pl, stream)
            joins.append((dev, stream.record_event()))
        for dev, ev in joins:
            torch.cuda.current_stream(dev).wait_event(ev)
        if tk:
            for dev in devs:  # the wave's single barrier
                _sync(dev)
            wave_ms = (time.perf_counter() - t0) * 1e3
        # every plan has replayed: what this wave's misses evicted may go
        self.cache.release_dropped()

        # retire: apportion the wave wall across ALL wave members by cost
        # weight (or read the cost clock), roll each chain's virtual times
        # forward independently, and account the wave's overlap
        all_ms = self._member_ms([c for pl in plans for c in pl["costs"]], wave_ms)
        busy = 0.0
        wi = 0
        for pl in plans:
            n = len(pl["members"])
            busy += self._retire_chain(pl, all_ms[wi:wi + n], record, wave=True)
            wi += n
        if self.comm is not None:
            spans = [(pl["lo"], pl["hi"]) for pl in plans if pl.get("lo") is not None]
            if spans:
                wave_lo = min(lo for lo, _ in spans)
                wave_hi = max(hi for _, hi in spans)
                self.vnow = max(self.vnow, wave_hi)
                # co-scheduled compute: member spans beyond the wave span
                self.overlap_ms += max(0.0, busy - (wave_hi - wave_lo))
                self.comm.poll(self.vnow)  # fire completion callbacks for landed pulls
        self.n_waves += 1
        self._prefetch_ready()
        return True

    def _seal_wave(self, plans: list[dict], consumers: dict[str, set[str]]) -> None:
        """A block whose every remaining consumer sits inside exactly ONE
        chain of this wave is dead outside it: drop the other groups' copies
        (incl. stale prefetches) so the consuming chain's copy becomes sole
        and :meth:`_donatable` can drop it after the chain — donation across
        group boundaries, unlocked by the seal."""
        g_nodes = self.g.nodes
        wave_grp_of = {n: pl["grp"] for pl in plans for n in pl["members"]}
        for pl in plans:
            grp = pl["grp"]
            for key in pl["ext_keys"]:
                if key in self._inputs or key not in g_nodes:
                    continue  # caller-owned seed / seeded "<kernel>/in" block
                succs = self.g.successors(key)
                if not succs:
                    continue  # exit output: result() must return it
                if len(consumers.get(key, ())) != 1:
                    continue  # two chains pulled it: neither copy is sole
                if not all(s in self._done or wave_grp_of.get(s) == grp for s in succs):
                    continue  # a consumer outside this wave still needs it
                ent = self.valid.get(key)
                if ent is None:
                    continue
                for ogrp in [o for o in ent if o != grp]:
                    del ent[ogrp]
                    self.vt_block.pop((key, ogrp), None)
                    self.prefetched.discard((key, ogrp))

    def step(self) -> KernelRun | None:
        """Execute the next ready kernel; ``None`` when the graph is drained.

        With ``time_kernels`` the kernel's wall time is bracketed by two
        synchronises of its group's device, so it covers the kernel's run on
        the card and not just its launch; the first synchronise (inputs
        ready) lies outside the timed region.

        In fused mode a whole group-step (or wave) executes at once (one
        graph replay per chain, one barrier) and its per-kernel records are
        replayed one per call, so online callers consume the same stepwise
        interface."""
        if self.fused:
            dispatch = self._fused_wave if self.async_groups else self._fused_superstep
            if not self._fused_buf and not dispatch():
                return None
            return self._fused_buf.pop(0)
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
        self.kernels_by_op[k.op] = self.kernels_by_op.get(k.op, 0) + 1
        self._prefetch_ready()
        return KernelRun(name, grp, ms, nt, nb, vstart, vfinish)

    def run_all(self) -> None:
        if self.fused:
            # drain whole group-steps directly: no one-record-per-step()
            # replay, no per-kernel KernelRun construction — batch callers
            # only consume the aggregate result()/superstep_runs state
            self._fused_buf.clear()
            dispatch = self._fused_wave if self.async_groups else self._fused_superstep
            while not self.done() and dispatch(record=False):
                pass
            return
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
            static_copies=self.static_copies,
            static_copy_bytes=self.static_copy_bytes,
        )


class TorchExecutor:
    def __init__(self, groups: Mapping[str, torch.device]):
        """groups: group name -> the torch device that group runs on."""
        self.groups = {name: torch.device(d) for name, d in groups.items()}
        self._streams: dict[str, torch.cuda.Stream] = {}

    def stream_of(self, group: str) -> torch.cuda.Stream:
        """The CUDA stream a CUDA group's wave chains run on (one per group,
        made at first use and kept)."""
        if group not in self._streams:
            self._streams[group] = torch.cuda.Stream(self.groups[group])
        return self._streams[group]

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
        fused: bool = False,
        cache: SuperStepCache | None = None,
        async_groups: bool = False,
        cost_clock: bool = False,
    ) -> ExecResult:
        """assignment: kernel -> group name.  ``inputs`` seeds the source
        blocks (host-resident, like the paper's initial data) on
        ``host_group`` (explicit, or the deterministic default)."""
        s = self.session(
            g, assignment, inputs, host_group=host_group, time_kernels=time_kernels,
            fused=fused, cache=cache, async_groups=async_groups, cost_clock=cost_clock,
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
