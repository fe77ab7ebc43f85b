"""The profiler's trace, reduced: kernels on the device, host operations,
the device's busy time (the union of kernel intervals), and the breakdown
the result line carries (the device operations that took most time, the
longest idle gaps by what the host was doing)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Trace:
    kernels: list[tuple[str, float, float]]   # (name, start us, end us) on the device
    host: list[tuple[str, float, float]]      # host operations, the same clock
    window_s: float                           # the traced slice, host clock
    about: str                                # which slice was traced

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_s(self, *keys: str) -> float:
        """Seconds of the kernels whose names hold any of ``keys``."""
        return sum(b - a for n, a, b in self.kernels if any(k in n for k in keys)) / 1e6

    def kernel_count(self, *keys: str) -> int:
        return sum(1 for n, _, _ in self.kernels if any(k in n for k in keys))

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict[str, float] = {}
        for n, a, b in self.kernels:
            by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e6
        gaps: dict[str, float] = {}
        busy = self.busy_intervals()
        host = sorted(self.host, key=lambda h: h[1])
        active: list = []
        nxt = 0
        # a sweep over the gaps in time order: the host operations open at
        # each gap's middle are few (their nesting depth)
        for (_, end), (start, _) in zip(busy, busy[1:]):
            mid = (end + start) / 2
            while nxt < len(host) and host[nxt][1] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[2] >= mid]
            label = min(active, key=lambda h: h[2] - h[1])[0] if active else "no host operation"
            gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e6
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": order(by_op), "idle_gaps": order(gaps)}


def from_profiler(prof, window_s: float, about: str) -> Trace:
    """The kernels and host operations of a stopped ``torch.profiler``."""
    import torch

    kernels, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append(span)
        else:
            host.append(span)
    return Trace(kernels=kernels, host=host, window_s=window_s, about=about)
