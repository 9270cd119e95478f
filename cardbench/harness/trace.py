"""Reduction of a traced window to what the per-layer readers read.

The traced run records ``torch.profiler`` (CPU and CUDA activity) over the
whole measured window, with one ``record_function`` span named ``CALL``
around every solve call the harness makes. ``Trace`` keeps, in the
profiler's microseconds:

  * ``device``: every device activity (kernels, copies, sets) as (name,
    start, end);
  * ``calls``: the harness's call spans as (start, end);
  * ``host``: the outermost other host events (not the CUDA runtime's
    calls) as (start, end, name), by start.
"""
from __future__ import annotations

import bisect
import dataclasses

CALL = "cardbench.call"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _outermost(events):
    """The host events that no other host event encloses, by start (the
    ops a script calls, not the ops they call)."""
    out = []
    for ev in sorted(events, key=lambda ev: (ev[0], -ev[1])):
        if not out or ev[0] >= out[-1][1]:
            out.append(ev)
    return out


@dataclasses.dataclass
class Trace:
    device: list[tuple[str, float, float]]
    calls: list[tuple[float, float]]
    host: list[tuple[float, float, str]]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType
        device, calls, host = [], [], []
        for e in prof.events():
            s, t = float(e.time_range.start), float(e.time_range.end)
            if e.name == CALL:
                # the profiler mirrors a host span onto the device's
                # timeline as an annotation; only the host's is a span
                if e.device_type != DeviceType.CUDA:
                    calls.append((s, t))
            elif e.device_type == DeviceType.CUDA:
                device.append((e.name, s, t))
            elif not e.name.startswith("cuda"):
                host.append((s, t, e.name))
        return cls(device, sorted(calls), _outermost(host))

    def busy_intervals(self):
        return _merge((s, e) for _, s, e in self.device)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device activity ran."""
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def busy_within_calls_s(self) -> float:
        """Seconds of device activity inside the harness's call spans."""
        busy = self.busy_intervals()
        total, i = 0.0, 0
        for cs, ce in _merge(self.calls):
            while i < len(busy) and busy[i][1] <= cs:
                i += 1
            j = i
            while j < len(busy) and busy[j][0] < ce:
                total += min(busy[j][1], ce) - max(busy[j][0], cs)
                j += 1
        return total * 1e-6

    def device_seconds(self, match) -> tuple[float, int]:
        """(seconds, launches) of the device activities whose name
        ``match(name)`` accepts."""
        hits = [(e - s) for name, s, e in self.device if match(name)]
        return sum(hits) * 1e-6, len(hits)

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time, summed by name."""
        by = {}
        for name, s, e in self.device:
            by[name[:120]] = by.get(name[:120], 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The device's idle time inside the window, summed by what the
        host was doing at each gap's middle: ``in <op>`` (the latest host
        event begun by then still runs), ``after <op>`` (it has ended),
        with ``between calls:`` outside the call spans."""
        if not self.calls:
            return []
        w0, w1 = self.calls[0][0], max(e for _, e in self.calls)
        starts = [h[0] for h in self.host]
        call_starts = [c[0] for c in self.calls]
        by = {}
        cursor = w0
        for s, e in self.busy_intervals() + [[w1, w1]]:
            s, e = max(s, w0), min(e, w1)
            if s > cursor:
                mid = 0.5 * (cursor + s)
                i = bisect.bisect_right(starts, mid) - 1
                if i < 0:
                    name = "no host event"
                else:
                    hs, he, hn = self.host[i]
                    name = f"{'in' if he >= mid else 'after'} {hn}"
                c = bisect.bisect_right(call_starts, mid) - 1
                if c < 0 or self.calls[c][1] < mid:
                    name = "between calls: " + name
                by[name[:120]] = by.get(name[:120], 0.0) + (s - cursor) * 1e-6
            cursor = max(cursor, e)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]
