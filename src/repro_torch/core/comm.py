"""Topology-aware communication engine: per-link transfer lanes.

The paper's platform model (§IV) is a single PCIe bus with one copy engine,
and until this module both backends mirrored it: the simulator kept one FIFO
``bus_free`` clock and the executor serialized modeled transfer time onto its
virtual clock.  Real heterogeneous fabrics are not one bus: host<->accelerator
and accelerator<->accelerator links have distinct bandwidths and latencies
(PCIe vs ICI vs DCN), links have *multiple* concurrent copy engines (lanes),
and a transfer in flight on one link does not serialize against compute or
against traffic on another link.

Two pieces, shared by the simulator and the real-device executor — one
communication model, two backends:

* :class:`Topology` — the link graph between memory nodes.  ``single_bus``
  reproduces the paper (every node pair shares one link object, so all
  transfers serialize through its lanes); ``dedicated`` gives every node pair
  its own lane set; :meth:`~Topology.add_link` overrides individual pairs
  (e.g. a fast host link next to a slow cross-pod DCN).
* :class:`CommEngine` — an event-driven transfer scheduler over the
  topology's lanes.  :meth:`~CommEngine.fetch` books one copy onto the
  earliest-free lane of the right link and returns its completion time; the
  caller owns data-validity bookkeeping (the simulator's ``valid`` map, the
  session's virtual block times), the engine owns *when the wire is busy*.
  Per-lane busy intervals never overlap — the conservation invariant
  ``tests/test_comm.py`` checks.

Transfers booked before their consumer runs (``kind="prefetch"``) are how
compute/transfer overlap happens: the copy proceeds while the destination
worker is still busy with the previous kernel, so the cut edges the
graph-partition policy minimizes are exactly the transfers that can hide
under compute.

Bulk fetches move a block in ONE booking, so a deep chain of cut edges pays
full transfer latency on every hop even with prefetch.  A
:class:`StreamChannel` (:meth:`CommEngine.open_stream`) instead splits the
copy into ``chunk_bytes`` chunks that overlap chunk-wise with the producer's
compute (chunks become available as the producer runs, not only at its
finish) and with the consumer's start (the consumer may begin once chunk 0
lands, charging residual arrivals against its own compute).  Channel depth
bounds the in-flight window: with ``depth`` chunks outstanding the producer
stalls (``n_stalled_chunks``) until the consumer drains one — classic
pipeline backpressure.  Chunks book per-tier lane segments exactly like bulk
fetches (same contention, same conservation invariants) and their durations
are a proportional split of the bulk booking's bottleneck duration, so a
channel never holds the wire longer than the bulk copy it replaces.

Real serving fleets are not flat either: nodes sit in racks, racks in pods,
and cross-rack / cross-pod traffic funnels through *shared* uplinks where
contention — not point-to-point bandwidth — decides what a cut costs.
:class:`HierTopology` models exactly that: each tier (leaf NIC, rack switch
uplink, pod uplink) has its own bandwidth/latency/lane pool and a transfer
books a lane on **every** tier it crosses, so two cross-pod copies between
disjoint node pairs still contend on the same pod uplink.  On hierarchical
topologies the engine also turns on **contention-aware prefetch throttling**
by default: a prefetch only books when every tier on its path has a free
lane *right now* — otherwise it is deferred (``n_throttled``) and retried at
the next scheduling event, so speculative copies never queue a later demand
fetch behind them on a hot tier.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from .cost import Link

REF_BYTES = 1 << 20  # representative block for relative link pricing
# Fixed streaming chunk size on flat topologies (and the floor unit all
# chunk-size math rounds to).  Hierarchical topologies derive a per-tier
# size instead — see :meth:`Topology.stream_chunk_bytes`.
DEFAULT_CHUNK_BYTES = 1 << 18


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One booked copy: ``block`` moved ``src`` -> ``dst`` on ``lane``.

    ``lanes`` lists every lane the copy occupies — one per tier crossed on a
    hierarchical topology, a 1-tuple on flat ones (``lane`` is the bottleneck
    tier's lane).  ``requested`` is when the copy was asked for, so
    ``finish - requested`` is the fetch latency including queueing.
    ``preempted`` marks a copy cancelled in flight (its destination group
    died); ``finish`` is then the preemption time, not the planned one."""

    block: str
    src: int
    dst: int
    nbytes: int
    start: float
    finish: float
    lane: str
    kind: str = "demand"  # "demand" | "prefetch" | "spill"
    lanes: tuple = ()
    requested: float = 0.0
    preempted: bool = False

    @property
    def all_lanes(self) -> tuple:
        return self.lanes or (self.lane,)


class Topology:
    """Per-link bandwidth/latency/lane model between memory nodes.

    ``shared_bus=True`` (the paper's platform): every node pair resolves to
    the ONE default link object, so all traffic serializes through its lanes.
    ``shared_bus=False``: every node pair gets its own dedicated lane set of
    the default link.  :meth:`add_link` overrides individual pairs either way
    (host<->class and class<->class links with distinct speeds).
    """

    # flat topologies never auto-enable prefetch throttling (bit-for-bit
    # back-compat); HierTopology flips this
    hierarchical = False

    def __init__(
        self,
        default: Link,
        *,
        default_lanes: int = 1,
        shared_bus: bool = True,
    ):
        if default_lanes < 1:
            raise ValueError("a link needs at least one lane")
        self.default = default
        self.default_lanes = default_lanes
        self.shared_bus = shared_bus
        self._links: dict[tuple[int, int], tuple[str, Link, int]] = {}

    @classmethod
    def single_bus(cls, link: Link, *, lanes: int = 1) -> "Topology":
        """The paper's model: one shared bus, ``lanes`` copy engines."""
        return cls(link, default_lanes=lanes, shared_bus=True)

    @classmethod
    def dedicated(cls, link: Link, *, lanes: int = 1) -> "Topology":
        """Every node pair gets its own ``lanes``-wide instance of ``link``."""
        return cls(link, default_lanes=lanes, shared_bus=False)

    def add_link(self, a: int, b: int, link: Link, *, lanes: int = 1) -> "Topology":
        """Dedicated link between memory nodes ``a`` and ``b`` (symmetric).
        Returns self, so topologies chain: ``Topology(...).add_link(...)``."""
        if lanes < 1:
            raise ValueError("a link needs at least one lane")
        key = (min(a, b), max(a, b))
        self._links[key] = (f"{link.name}:{key[0]}-{key[1]}", link, lanes)
        return self

    def copy(self) -> "Topology":
        t = Topology(
            self.default,
            default_lanes=self.default_lanes,
            shared_bus=self.shared_bus,
        )
        t._links = dict(self._links)
        return t

    # -- resolution ----------------------------------------------------------

    def link_of(self, src: int, dst: int) -> tuple[str, Link, int]:
        """(lane-group key, link, lanes) for a ``src`` -> ``dst`` copy."""
        key = (min(src, dst), max(src, dst))
        ent = self._links.get(key)
        if ent is not None:
            return ent
        if self.shared_bus:
            return (f"{self.default.name}:bus", self.default, self.default_lanes)
        name = f"{self.default.name}:{key[0]}-{key[1]}"
        return (name, self.default, self.default_lanes)

    def route(self, src: int, dst: int) -> list[tuple[str, Link, int]]:
        """The lane groups a ``src`` -> ``dst`` copy must book, in path order.
        Flat topologies are single-hop: one link per node pair.  Hierarchical
        topologies return every tier the copy crosses."""
        return [self.link_of(src, dst)]

    def links(self) -> list[tuple[str, Link, int]]:
        """Every explicitly registered link plus the default."""
        out = [(f"{self.default.name}:*", self.default, self.default_lanes)]
        out.extend(self._links.values())
        return out

    # -- pricing -------------------------------------------------------------

    def transfer_ms(
        self, nbytes: int, src: int | None = None, dst: int | None = None
    ) -> float:
        """Transfer time over the actual ``src`` -> ``dst`` link; without
        endpoints, the conservative worst-link price (the cut objective's
        scalar: an edge must be priced before its endpoints' classes are
        known, and the slowest link bounds what a cut can cost)."""
        if src is None or dst is None:
            return self.worst_ms(nbytes)
        if src == dst:
            return 0.0
        _, link, _ = self.link_of(src, dst)
        return link.transfer_ms(nbytes)

    def worst_ms(self, nbytes: int) -> float:
        return max(link.transfer_ms(nbytes) for _, link, _ in self.links())

    def stream_chunk_bytes(self, src: int | None = None, dst: int | None = None) -> int:
        """Default chunk size for a streaming channel over ``src`` -> ``dst``.

        Flat topologies keep the fixed :data:`DEFAULT_CHUNK_BYTES` (exact
        back-compat for every pre-existing streaming number); hierarchical
        topologies size chunks to the route's bottleneck tier — see
        :meth:`HierTopology.stream_chunk_bytes`.  Callers passing an explicit
        ``chunk_bytes`` always win; this is only the ``None`` default."""
        return DEFAULT_CHUNK_BYTES

    def scale_matrix(
        self, nodes: Sequence[int], ref_bytes: int = REF_BYTES
    ) -> list[list[float]]:
        """Relative cut-cost matrix for the partitioner: entry (i, j) is the
        node_i <-> node_j transfer price of a representative block divided by
        the worst-link price (diagonal 0 — same node, no transfer).  Edge
        weights priced at the worst link times this matrix give link-aware
        cut costs in the FM gain function."""
        ref = self.worst_ms(ref_bytes)
        k = len(nodes)
        out = [[0.0] * k for _ in range(k)]
        for i in range(k):
            for j in range(k):
                if nodes[i] == nodes[j]:
                    continue
                out[i][j] = self.transfer_ms(ref_bytes, nodes[i], nodes[j]) / ref
        return out


class HierTopology(Topology):
    """Rack/pod hierarchy with shared uplinks between memory nodes.

    Three tiers, each with its own :class:`~repro_torch.core.cost.Link` and lane
    pool:

    * ``leaf`` — every node's NIC into its rack switch (lane group per node);
    * ``rack`` — every rack's uplink into its pod switch (lane group per
      rack, shared by all that rack's nodes);
    * ``pod`` — every pod's uplink into the cross-pod spine (lane group per
      pod, shared by *everything* leaving the pod).

    A transfer books a lane on every tier it crosses: same-rack copies ride
    the two leaf NICs, cross-rack copies additionally book both rack
    uplinks, and cross-pod copies both pod uplinks too — so two cross-pod transfers
    between disjoint node pairs still contend on the shared uplinks, which is
    the regime where partition locality (not point-to-point bandwidth)
    decides the cut cost.  The transfer's wall time is priced at the
    bottleneck tier (cut-through routing: every crossed lane is held for the
    whole copy).

    Nodes absent from ``node_rack`` (and racks absent from ``rack_pod``) get
    a synthetic rack/pod of their own, so unknown endpoints always price and
    contend as worst-case cross-pod traffic — the same conservative fallback
    the flat ``link_scale_matrix`` uses for unknown classes.
    """

    hierarchical = True

    def __init__(
        self,
        *,
        leaf: Link,
        rack: Link,
        pod: Link,
        node_rack: Mapping[int, object],
        rack_pod: Mapping[object, object],
        leaf_lanes: int = 1,
        rack_lanes: int = 1,
        pod_lanes: int = 1,
    ):
        super().__init__(pod, default_lanes=pod_lanes, shared_bus=False)
        if min(leaf_lanes, rack_lanes, pod_lanes) < 1:
            raise ValueError("every tier needs at least one lane")
        self.leaf = leaf
        self.rack = rack
        self.pod = pod
        self.node_rack = dict(node_rack)
        self.rack_pod = dict(rack_pod)
        self.leaf_lanes = leaf_lanes
        self.rack_lanes = rack_lanes
        self.pod_lanes = pod_lanes

    def copy(self) -> "HierTopology":
        return HierTopology(
            leaf=self.leaf,
            rack=self.rack,
            pod=self.pod,
            node_rack=self.node_rack,
            rack_pod=self.rack_pod,
            leaf_lanes=self.leaf_lanes,
            rack_lanes=self.rack_lanes,
            pod_lanes=self.pod_lanes,
        )

    def add_link(self, a: int, b: int, link: Link, *, lanes: int = 1):
        raise NotImplementedError(
            "HierTopology prices paths by tier, not per-pair links"
        )

    # -- membership ----------------------------------------------------------

    def rack_of(self, node: int):
        """The node's rack; unknown nodes get a private synthetic rack."""
        return self.node_rack.get(node, ("?rack", node))

    def pod_of(self, node: int):
        """The node's pod; unknown racks get a private synthetic pod."""
        rack = self.rack_of(node)
        return self.rack_pod.get(rack, ("?pod", rack))

    # -- resolution ----------------------------------------------------------

    def route(self, src: int, dst: int) -> list[tuple[str, Link, int]]:
        """Every tier lane group a ``src`` -> ``dst`` copy crosses, leaf out
        through the shared uplinks and back down.  Same-node routes (spill
        staging) occupy just the node's own NIC."""
        segs = [(f"leaf:{src}", self.leaf, self.leaf_lanes)]
        if src == dst:
            return segs
        ra, rb = self.rack_of(src), self.rack_of(dst)
        if ra != rb:
            segs.append((f"rack:{ra}", self.rack, self.rack_lanes))
            pa, pb = self.pod_of(src), self.pod_of(dst)
            if pa != pb:
                segs.append((f"pod:{pa}", self.pod, self.pod_lanes))
                segs.append((f"pod:{pb}", self.pod, self.pod_lanes))
            segs.append((f"rack:{rb}", self.rack, self.rack_lanes))
        segs.append((f"leaf:{dst}", self.leaf, self.leaf_lanes))
        return segs

    def link_of(self, src: int, dst: int) -> tuple[str, Link, int]:
        """The bottleneck tier of the path (slowest crossed link)."""
        return max(
            self.route(src, dst), key=lambda seg: seg[1].transfer_ms(REF_BYTES)
        )

    def links(self) -> list[tuple[str, Link, int]]:
        return [
            ("leaf:*", self.leaf, self.leaf_lanes),
            ("rack:*", self.rack, self.rack_lanes),
            ("pod:*", self.pod, self.pod_lanes),
        ]

    # -- pricing -------------------------------------------------------------

    def transfer_ms(
        self, nbytes: int, src: int | None = None, dst: int | None = None
    ) -> float:
        """Bottleneck-tier price of the actual path (leaf for same-rack,
        rack uplink for cross-rack, pod uplink for cross-pod); endpoint-free
        calls price at the worst tier, exactly as the flat model prices at
        the worst link."""
        if src is None or dst is None:
            return self.worst_ms(nbytes)
        if src == dst:
            return 0.0
        return max(link.transfer_ms(nbytes) for _, link, _ in self.route(src, dst))

    def stream_chunk_bytes(self, src: int | None = None, dst: int | None = None) -> int:
        """Tier-aware chunk sizing: a chunk's wire time should dominate the
        per-chunk latency, so the chunk carries ~4 latency-bandwidth products
        of its bottleneck tier, rounded to a power of two in [16 KiB, 4 MiB].
        High-latency DCN-class pod uplinks get MiB-scale chunks (latency
        amortized), low-latency leaf/ICI NICs stay at fine chunks (tight
        pipelining).  Endpoint-free calls price at the worst tier — the same
        conservative convention as :meth:`transfer_ms`."""
        if src is None or dst is None or src == dst:
            links = [link for _, link, _ in self.links()]
            link = max(links, key=lambda lk: lk.transfer_ms(REF_BYTES))
        else:
            _, link, _ = self.link_of(src, dst)  # bottleneck tier of the route
        ideal = 4.0 * (link.latency_ms * 1e-3) * link.bw
        size = 1 << 14
        while size < ideal and size < (1 << 22):
            size <<= 1
        return size


class StreamChannel:
    """One chunked ``src`` -> ``dst`` transfer pipelined against its producer
    and consumer.

    Two-phase protocol (the consumer's start and compute time are only known
    when it is dispatched):

    1. :meth:`CommEngine.open_stream` picks ONE lane per crossed tier (the
       channel is a single connection: its chunks serialize on those lanes,
       other traffic interleaves normally) and books chunk 0.  Chunk ``i``
       becomes available at the producer pro-rata: a producer computing over
       ``[src_start, src_ready]`` emits chunk ``i`` at
       ``src_start + (i+1)/n * (src_ready - src_start)`` — so chunk 0 may be
       on the wire long before the producer finishes, which is exactly the
       overlap a bulk fetch (bookable only after ``src_ready``) can never
       get.  ``first_ready`` is chunk 0's arrival: the earliest the consumer
       may start.
    2. :meth:`drain` books chunks ``1..n-1`` against the consumer's compute
       window.  The consumer drains uniformly (one chunk per
       ``compute_ms / n``); with ``depth`` chunks in flight or undrained the
       next chunk stalls until the consumer frees a slot
       (``n_stalled_chunks``).  Returns ``(finish, arrival_last)``: when the
       consumer completes (all chunks arrived AND consumed) and when the
       last chunk landed (the block is valid at ``dst`` from then on).

    Chunk durations are a proportional split of the bulk booking's
    bottleneck duration (latency amortized pro-rata), so the channel's total
    wire time equals the bulk fetch's exactly — streaming can move a kernel's
    start earlier, never hold a lane longer.
    """

    def __init__(
        self,
        engine: "CommEngine",
        block: str,
        src: int,
        dst: int,
        nbytes: int,
        *,
        depth: int,
        sizes: list[int],
        durs: list[float],
        readies: list[float],
        picks: list,
        bottleneck: int,
        requested: float,
    ):
        self.engine = engine
        self.block = block
        self.src = src
        self.dst = dst
        self.nbytes = nbytes
        self.depth = depth  # 0 = unbounded
        self.sizes = sizes
        self.durs = durs
        self.readies = readies
        self.picks = picks
        self.bottleneck = bottleneck
        self.requested = requested
        self.n_chunks = len(sizes)
        self.n_stalled = 0
        self.stall_ms = 0.0
        # phase 1: chunk 0 goes on the wire at open
        self.first_ready = engine._book_chunk(self, 0, self.readies[0])
        self.finish: float | None = None
        self.arrival_last: float | None = None

    def drain(self, consume_start: float, compute_ms: float) -> tuple[float, float]:
        """Book chunks ``1..n-1`` against the consumer computing over
        ``[consume_start, consume_start + compute_ms]``; returns
        ``(finish, arrival_last)`` (see class docstring)."""
        n = self.n_chunks
        per_chunk = compute_ms / n
        consumed = [0.0] * n
        consumed[0] = max(consume_start, self.first_ready) + per_chunk
        arrival = self.first_ready
        for i in range(1, n):
            floor = max(
                self.readies[i],
                max(frees[lane_i] for _, frees, lane_i in self.picks),
            )
            if self.depth and i >= self.depth:
                gate = consumed[i - self.depth]  # backpressure: window full
                if gate > floor + 1e-9:
                    self.n_stalled += 1
                    self.stall_ms += gate - floor
                    self.engine.n_stalled_chunks += 1
                    self.engine.stall_ms += gate - floor
                    floor = gate
            arrival = self.engine._book_chunk(self, i, floor)
            consumed[i] = max(consumed[i - 1], arrival) + per_chunk
        self.finish = max(consumed[n - 1], consume_start + compute_ms)
        self.arrival_last = arrival
        return self.finish, self.arrival_last


@dataclasses.dataclass
class AsyncPull:
    """Handle for a non-blocking pull (:meth:`CommEngine.fetch_async`).

    The booking happens immediately — lanes are charged exactly as a
    blocking :meth:`~CommEngine.fetch` would — but the caller gets this
    handle back instead of waiting on the completion time: ``eta`` is the
    modeled arrival (``None`` for a throttled prefetch that moved nothing),
    :meth:`done` answers "has it landed by ``now``", and completion
    callbacks registered with :meth:`on_complete` fire when the engine is
    :meth:`~CommEngine.poll` ed past the ETA.  This is the wave executor's
    admission primitive: a group joins a wave as soon as the last of its
    pulls' ETAs lands."""

    block: str
    src: int
    dst: int
    nbytes: int
    eta: float | None
    requested: float = 0.0
    fired: bool = False
    _callbacks: list = dataclasses.field(default_factory=list)

    def done(self, now: float) -> bool:
        return self.eta is not None and self.eta <= now + 1e-9

    def on_complete(self, cb) -> None:
        """Register ``cb(handle)`` to fire at the first ``poll`` past the
        ETA (immediately if the handle already fired)."""
        if self.fired:
            cb(self)
        else:
            self._callbacks.append(cb)

    def _fire(self) -> None:
        self.fired = True
        for cb in self._callbacks:
            cb(self)
        self._callbacks.clear()


class CommEngine:
    """Event-driven transfer scheduler over a :class:`Topology`'s lanes.

    Pure resource model: :meth:`fetch` books one copy on the earliest-free
    lane of every link on the route and returns its completion time.
    Validity (which node holds which block) is the caller's job — the
    simulator keeps its ``valid`` map, the executor session its virtual block
    times — so the same engine backs both without owning either's
    consistency protocol.

    ``throttle`` (default: on for hierarchical topologies, off for flat
    ones) is the contention-aware prefetch policy: a ``kind="prefetch"``
    fetch only books when every lane group on its path has a free lane at
    the desired start — a prefetch that would queue (and that a later demand
    fetch would then queue *behind* on a hot tier) is rejected instead
    (``None`` return, counted in ``n_throttled``); the caller retries at its
    next scheduling event, by which point the consumer may simply demand the
    block at full priority.  Demand fetches and spills always book.
    """

    def __init__(
        self,
        topo: Topology,
        *,
        throttle: bool | None = None,
        adaptive_depth: bool = False,
        base_depth: int = 1,
        min_depth: int = 1,
        max_depth: int = 4,
        idle_window_ms: float = 5.0,
    ):
        self.topo = topo
        self.throttle = topo.hierarchical if throttle is None else throttle
        self._lane_free: dict[str, list[float]] = {}
        self.transfers: list[Transfer] = []
        self.n_transfers = 0
        self.n_prefetched = 0
        # distinct (block, dst) prefetches the throttle deferred at least
        # once — callers retry a deferred prefetch at every scheduling event,
        # and those retries must not inflate the surfaced counter
        self._throttled: set[tuple[str, int]] = set()
        self.bytes_transferred = 0
        self.busy_ms = 0.0
        self.n_preempted = 0
        self.kind_counts: dict[str, int] = {}
        self.kind_bytes: dict[str, int] = {}
        # streaming channels (open_stream)
        self.n_streamed = 0
        self.n_stalled_chunks = 0
        self.stall_ms = 0.0
        self.stream_busy_ms = 0.0
        # adaptive per-tier prefetch depth: tiers idle >= idle_window_ms earn
        # a deeper speculative window (up to max_depth), tiers that throttle
        # a prefetch fall back toward min_depth
        self.adaptive_depth = adaptive_depth
        self.base_depth = max(1, base_depth)
        self.min_depth = max(1, min_depth)
        self.max_depth = max(self.min_depth, max_depth)
        self.idle_window_ms = idle_window_ms
        self.n_depth_adjust = 0
        self._tier_depth: dict[str, int] = {}
        self._tier_raised_at: dict[str, float] = {}
        # outstanding non-blocking pulls (fetch_async) awaiting a poll()
        self._async_pulls: list[AsyncPull] = []

    @property
    def n_throttled(self) -> int:
        """Distinct prefetches (block, destination) the contention throttle
        deferred at least once — not retry attempts."""
        return len(self._throttled)

    def fetch(
        self,
        block: str,
        src: int,
        dst: int,
        nbytes: int,
        *,
        now: float,
        src_ready: float = 0.0,
        kind: str = "demand",
        book_same_node: bool = False,
    ) -> float | None:
        """Book one ``src`` -> ``dst`` copy; returns its completion time.

        The copy starts at max(now, source-ready, earliest-free lane of
        every crossed link) — a busy link queues the transfer, an idle one
        overlaps it with whatever compute is running.  On a hierarchical
        topology the copy occupies one lane per crossed tier for its whole
        duration, priced at the bottleneck tier.  Same-node "copies" are
        free and not booked, unless ``book_same_node`` forces the booking
        (spills from a host-coresident memory node still cross a staging
        link).  A throttled prefetch books nothing and returns ``None``
        (see class docstring)."""
        if src == dst and not book_same_node:
            return max(now, src_ready)
        segs = self.topo.route(src, dst)
        # Duplex links carry opposing directions on independent lane pools:
        # the lane-group key gains a direction suffix, so an A->B copy never
        # queues behind a B->A one.  Simplex links (duplex=False, the
        # default) keep the undecorated key — bit-identical bookings.
        direction = ">" if src <= dst else "<"
        picks: list[tuple[str, list[float], int]] = []
        for key, link, lanes in segs:
            if link.duplex:
                key = f"{key}{direction}"
            frees = self._lane_free.setdefault(key, [0.0] * lanes)
            lane_i = min(range(lanes), key=lambda i: (frees[i], i))
            picks.append((key, frees, lane_i))
        want = max(now, src_ready)
        start = max([want] + [frees[i] for _, frees, i in picks])
        if kind == "prefetch" and self.throttle and start > want + 1e-9:
            self._throttled.add((block, dst))
            if self.adaptive_depth:
                # contention observed: shrink the speculative window of every
                # tier whose lanes actually blocked the prefetch
                for (key, _link, _lanes), (_k, frees, lane_i) in zip(segs, picks):
                    if frees[lane_i] <= want + 1e-9:
                        continue
                    d = self._tier_depth.get(key, self.base_depth)
                    if d > self.min_depth:
                        self._tier_depth[key] = d - 1
                        self.n_depth_adjust += 1
            return None
        dur = max(link.transfer_ms(nbytes) for _, link, _ in segs)
        finish = start + dur
        lanes_used = []
        for key, frees, lane_i in picks:
            frees[lane_i] = finish
            lanes_used.append(f"{key}[{lane_i}]")
        bottleneck = max(
            range(len(segs)), key=lambda i: segs[i][1].transfer_ms(nbytes)
        )
        self.transfers.append(
            Transfer(
                block,
                src,
                dst,
                nbytes,
                start,
                finish,
                lanes_used[bottleneck],
                kind,
                lanes=tuple(lanes_used),
                requested=want,
            )
        )
        self.n_transfers += 1
        if kind == "prefetch":
            self.n_prefetched += 1
        self.bytes_transferred += nbytes
        self.busy_ms += dur * len(segs)
        self.kind_counts[kind] = self.kind_counts.get(kind, 0) + 1
        self.kind_bytes[kind] = self.kind_bytes.get(kind, 0) + nbytes
        return finish

    def fetch_async(
        self,
        block: str,
        src: int,
        dst: int,
        nbytes: int,
        *,
        now: float,
        src_ready: float = 0.0,
        kind: str = "demand",
    ) -> AsyncPull:
        """Non-blocking :meth:`fetch`: the copy is booked on the lanes right
        away (identical contention/accounting) but the caller continues
        immediately with an :class:`AsyncPull` handle instead of the bare
        completion time.  Completion callbacks fire at the next
        :meth:`poll` past the ETA."""
        eta = self.fetch(
            block, src, dst, nbytes, now=now, src_ready=src_ready, kind=kind
        )
        h = AsyncPull(
            block, src, dst, nbytes, eta=eta, requested=max(now, src_ready)
        )
        if eta is not None:
            self._async_pulls.append(h)
        return h

    def poll(self, now: float) -> list[AsyncPull]:
        """Fire (and return) every outstanding async pull whose ETA has
        landed by ``now``; the rest stay queued for a later poll."""
        landed = [h for h in self._async_pulls if h.done(now)]
        if landed:
            self._async_pulls = [h for h in self._async_pulls if not h.done(now)]
            for h in landed:
                h._fire()
        return landed

    def open_stream(
        self,
        block: str,
        src: int,
        dst: int,
        nbytes: int,
        *,
        now: float,
        src_start: float | None = None,
        src_ready: float = 0.0,
        chunk_bytes: int | None = None,
        depth: int = 2,
    ) -> StreamChannel | None:
        """Open a chunked channel for ``block`` (see :class:`StreamChannel`).

        Picks one lane per crossed tier (earliest-free, same rule as
        :meth:`fetch`) and books chunk 0; the consumer may start at the
        returned channel's ``first_ready`` and must :meth:`~StreamChannel.drain`
        it once its compute window is known.  ``src_start``/``src_ready``
        bound the producer's compute: chunks become available pro-rata over
        that window (``src_start=None`` = the block already exists in full at
        ``src_ready``).  ``depth=0`` is an unbounded channel (no
        backpressure).  Same-node streams need no wire: returns ``None``.

        Channels count ONCE in ``n_transfers``/``bytes_transferred`` (they
        replace one bulk fetch) but log every chunk as a ``kind="stream"``
        :class:`Transfer`, so per-lane busy accounting — and the conservation
        invariant — see the real chunk intervals."""
        if src == dst:
            return None
        if chunk_bytes is None:
            # topology-driven default: tier-aware on hierarchies, the fixed
            # DEFAULT_CHUNK_BYTES on flat topologies (explicit sizes win)
            chunk_bytes = self.topo.stream_chunk_bytes(src, dst)
        if chunk_bytes < 1:
            raise ValueError("chunk_bytes must be positive")
        segs = self.topo.route(src, dst)
        direction = ">" if src <= dst else "<"
        picks: list[tuple[str, list[float], int]] = []
        for key, link, lanes in segs:
            if link.duplex:
                key = f"{key}{direction}"
            frees = self._lane_free.setdefault(key, [0.0] * lanes)
            lane_i = min(range(lanes), key=lambda i: (frees[i], i))
            picks.append((key, frees, lane_i))
        n = max(1, -(-nbytes // chunk_bytes))
        sizes = [chunk_bytes] * (n - 1) + [nbytes - chunk_bytes * (n - 1)]
        # proportional split of the bulk bottleneck duration: total wire time
        # is EXACTLY what one bulk fetch would book
        full_dur = max(link.transfer_ms(nbytes) for _, link, _ in segs)
        durs = [full_dur * s / nbytes for s in sizes]
        if src_start is None or src_ready <= src_start:
            readies = [src_ready] * n
        else:
            span = src_ready - src_start
            readies = [src_start + (i + 1) / n * span for i in range(n)]
        bottleneck = max(
            range(len(segs)), key=lambda i: segs[i][1].transfer_ms(nbytes)
        )
        ch = StreamChannel(
            self,
            block,
            src,
            dst,
            nbytes,
            depth=max(0, depth),
            sizes=sizes,
            durs=durs,
            readies=readies,
            picks=picks,
            bottleneck=bottleneck,
            requested=max(now, src_ready),
        )
        self.n_transfers += 1
        self.n_streamed += 1
        self.bytes_transferred += nbytes
        self.kind_counts["stream"] = self.kind_counts.get("stream", 0) + 1
        self.kind_bytes["stream"] = self.kind_bytes.get("stream", 0) + nbytes
        return ch

    def _book_chunk(self, ch: StreamChannel, i: int, floor: float) -> float:
        """Book channel chunk ``i`` no earlier than ``floor`` on the
        channel's picked lanes; returns its arrival time."""
        start = max(floor, max(frees[lane_i] for _, frees, lane_i in ch.picks))
        finish = start + ch.durs[i]
        lanes_used = []
        for key, frees, lane_i in ch.picks:
            frees[lane_i] = finish
            lanes_used.append(f"{key}[{lane_i}]")
        self.transfers.append(
            Transfer(
                ch.block,
                ch.src,
                ch.dst,
                ch.sizes[i],
                start,
                finish,
                lanes_used[ch.bottleneck],
                "stream",
                lanes=tuple(lanes_used),
                requested=ch.requested,
            )
        )
        self.busy_ms += ch.durs[i] * len(ch.picks)
        self.stream_busy_ms += ch.durs[i] * len(ch.picks)
        return finish

    def prefetch_depth_for(self, src: int, dst: int, now: float) -> int:
        """How many ready-queue entries ahead a prefetch toward ``dst`` may
        look (min over the route's per-tier depths).  With
        ``adaptive_depth``, querying is also when tiers adapt UP: a tier
        whose lanes have all been idle for ``idle_window_ms`` earns one more
        depth step (to ``max_depth``); throttled prefetches shrink it again
        (see :meth:`fetch`).  Without ``adaptive_depth``: ``base_depth``."""
        if not self.adaptive_depth:
            return self.base_depth
        depth = self.max_depth
        for key, _link, _lanes in self.topo.route(src, dst):
            d = self._tier_depth.get(key, self.base_depth)
            idle_since = max(self._tier_tail(key), self._tier_raised_at.get(key, 0.0))
            if d < self.max_depth and now - idle_since >= self.idle_window_ms:
                d += 1
                self._tier_depth[key] = d
                self._tier_raised_at[key] = now
                self.n_depth_adjust += 1
            depth = min(depth, d)
        return depth

    def _tier_tail(self, key: str) -> float:
        """Latest booked lane time on a tier's lane groups (both directions
        of a duplex link)."""
        tail = 0.0
        for k, frees in self._lane_free.items():
            if k == key or (k[:-1] == key and k[-1] in "<>"):
                tail = max(tail, max(frees))
        return tail

    def preempt_dst(self, dst: int, now: float) -> list[Transfer]:
        """Cancel every copy still in flight (or queued) toward memory node
        ``dst`` and release its remaining lane time on every crossed tier.

        Called when a destination group dies (worker drop / eviction): a
        copy nobody will consume must not hold lanes for its full
        bottleneck-tier duration.  A partially-done copy is truncated at
        ``now``; a not-yet-started one releases its whole booking.  Returns
        the ORIGINAL (pre-truncation) records so the caller can undo its
        validity bookkeeping; the cancelled copies are counted in
        ``n_preempted``."""
        cancelled: list[Transfer] = []
        for i, t in enumerate(self.transfers):
            if t.dst != dst or t.preempted or t.finish <= now + 1e-9:
                continue
            if t.start >= now:  # never started: release the whole booking
                released, start, finish = t.finish - t.start, now, now
            else:  # partially done: truncate at the preemption time
                released, start, finish = t.finish - now, t.start, now
            self.busy_ms -= released * len(t.all_lanes)
            self.transfers[i] = dataclasses.replace(
                t, start=start, finish=finish, preempted=True
            )
            cancelled.append(t)
        if cancelled:
            self.n_preempted += len(cancelled)
            # lane clocks only track the tail of each lane's booking queue,
            # so releasing segments means recomputing tails from what remains
            for frees in self._lane_free.values():
                for i in range(len(frees)):
                    frees[i] = 0.0
            for t in self.transfers:
                for lane in t.all_lanes:
                    key, _, idx = lane.rpartition("[")
                    frees = self._lane_free[key]
                    i = int(idx[:-1])
                    frees[i] = max(frees[i], t.finish)
        return cancelled

    def lane_busy_ms(self) -> dict[str, float]:
        """Total booked time per lane (conservation: sums to ``busy_ms``)."""
        out: dict[str, float] = {}
        for t in self.transfers:
            for lane in t.all_lanes:
                out[lane] = out.get(lane, 0.0) + (t.finish - t.start)
        return out

    def tier_busy_ms(self) -> dict[str, float]:
        """Booked lane time aggregated per tier (the lane key's prefix:
        ``leaf``/``rack``/``pod`` on a hierarchy, the link name on flat
        topologies) — the contention signal the throttle acts on."""
        out: dict[str, float] = {}
        for lane, ms in self.lane_busy_ms().items():
            tier = lane.split(":", 1)[0]
            out[tier] = out.get(tier, 0.0) + ms
        return out

    def demand_latency_ms(self) -> float:
        """Total demand-fetch latency (completion minus request time,
        queueing included) — the quantity prefetch throttling exists to
        protect."""
        return sum(
            t.finish - t.requested for t in self.transfers if t.kind == "demand"
        )

    def lane_log(self) -> dict[str, list[Transfer]]:
        """Per-lane transfer intervals in booking order (for invariants)."""
        out: dict[str, list[Transfer]] = {}
        for t in self.transfers:
            for lane in t.all_lanes:
                out.setdefault(lane, []).append(t)
        return out


def platform_topology(platform) -> Topology:
    """The platform's declared topology, or the paper's single shared bus
    built from its ``link`` (back-compat: platforms predating topologies
    behave exactly as before)."""
    topo = getattr(platform, "topology", None)
    if topo is not None:
        return topo
    return Topology.single_bus(platform.link)


def class_nodes_of(platform) -> dict[str, int]:
    """class -> memory-node id, for link-aware partition pricing."""
    return {cls: platform.node_of_class(cls) for cls in platform.classes}


def link_scale_matrix(
    topo: Topology,
    class_nodes: Sequence[int] | dict,
    classes: Sequence[str],
    ref_bytes: int = REF_BYTES,
) -> list[list[float]] | None:
    """Partitioner ``link_scale`` matrix over ``classes`` from an explicit
    class -> node map.  ``None`` when every class pair rides the same link
    (the scalar cut objective is exact).  Classes without a known node get
    DISTINCT fresh node ids past every known node and link endpoint, so
    unknown pairs price at the default link (never as free same-node, never
    colliding with a real node's fast link)."""
    known = dict(class_nodes)
    endpoints = [n for pair in topo._links for n in pair]
    fallback = max([*known.values(), *endpoints, 0]) + 1
    nodes = [known.get(c, fallback + i) for i, c in enumerate(classes)]
    scale = topo.scale_matrix(nodes, ref_bytes)
    off = [scale[i][j] for i in range(len(nodes)) for j in range(len(nodes)) if i != j]
    if not off or max(off) - min(off) < 1e-12:
        return None
    return scale


def link_scale_for(
    platform, classes: Sequence[str], ref_bytes: int = REF_BYTES
) -> list[list[float]] | None:
    """:func:`link_scale_matrix` over a platform's declared topology and
    live class -> node map."""
    return link_scale_matrix(
        platform_topology(platform), class_nodes_of(platform), classes, ref_bytes
    )


__all__ = [
    "AsyncPull",
    "CommEngine",
    "DEFAULT_CHUNK_BYTES",
    "HierTopology",
    "StreamChannel",
    "Topology",
    "Transfer",
    "class_nodes_of",
    "link_scale_for",
    "link_scale_matrix",
    "platform_topology",
    "REF_BYTES",
]
