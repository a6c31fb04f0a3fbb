"""The traced run's record: a ``torch.profiler`` window kept in memory and
reduced to device busy time, device time inside each of the benchmark's
spans, host-to-device copies, the top device operations and the longest
idle gaps.

Events are ``(name, on_device, start_ns, dur_ns)``.  The profiler puts a
``record_function`` range on the host and again on the device; a device
event whose name is also a host event's is such a range, not an operation.
Spans are the benchmark's own host ranges named ``bench.<span>``; each ends
in a synchronise, so the device operations that start inside one belong to
it."""

from __future__ import annotations

import contextlib
import time

SPAN_PREFIX = "bench."
WINDOW = "bench.window"


@contextlib.contextmanager
def span(record: dict, name: str, sync):
    """Time the body on the host clock, ending in ``sync()``, under a
    profiler range ``bench.<name>``; the milliseconds go to
    ``record["spans"][name]``."""
    from torch.profiler import record_function

    with record_function(SPAN_PREFIX + name):
        t0 = time.perf_counter()
        yield
        sync()
        record["spans"].setdefault(name, []).append(1e3 * (time.perf_counter() - t0))


def events_of(prof) -> list[tuple]:
    """A finished ``torch.profiler.profile`` -> its events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = "CUDA" in str(e.device_type())
        out.append((e.name(), on_dev, int(e.start_ns()), int(e.duration_ns())))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: list[tuple], top: int = 10) -> dict | None:
    """Events -> ``window_s``, ``busy_s``, ``ops_s`` (device time by
    operation), ``span_device_s`` and ``span_h2d_s`` (device time of the
    operations, and of the host-to-device copies, that start inside each
    span), ``h2d_s``, ``device_ops`` and ``idle_gaps`` (the ``top`` largest,
    ``[name, seconds]``).  None without a ``bench.window`` range."""
    host = [e for e in events if not e[1]]
    host_names = {e[0] for e in host}
    win = [e for e in host if e[0] == WINDOW]
    if not win:
        return None
    w0, w1 = win[0][2], win[0][2] + win[0][3]
    ops = [e for e in events if e[1] and e[0] not in host_names
           and e[2] >= w0 and e[2] < w1 and e[3] >= 0]
    spans = [e for e in host if e[0].startswith(SPAN_PREFIX) and e[0] != WINDOW]
    spans.sort(key=lambda e: e[2])
    ops_s: dict[str, float] = {}
    span_dev: dict[str, float] = {}
    span_h2d: dict[str, float] = {}
    h2d = 0.0
    starts = [s[2] for s in spans]
    import bisect

    for name, _, s, d in ops:
        ops_s[name] = ops_s.get(name, 0.0) + d * 1e-9
        is_h2d = name.startswith("Memcpy HtoD")
        if is_h2d:
            h2d += d * 1e-9
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < spans[i][2] + spans[i][3]:
            key = spans[i][0][len(SPAN_PREFIX):]
            if is_h2d:
                span_h2d[key] = span_h2d.get(key, 0.0) + d * 1e-9
            elif not name.startswith("Memcpy") and not name.startswith("Memset"):
                span_dev[key] = span_dev.get(key, 0.0) + d * 1e-9
    busy = _union([(max(s, w0), min(s + d, w1)) for _, _, s, d in ops])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[_host_doing(host, spans, g), (g[1] - g[0]) * 1e-9] for g in gaps[:top]]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_s, "ops_s": ops_s,
            "span_device_s": span_dev, "span_h2d_s": span_h2d, "h2d_s": h2d,
            "device_ops": sorted(([k, v] for k, v in ops_s.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": named}


def _host_doing(host, spans, gap) -> str:
    """What the host was doing over an idle gap: the benchmark span around
    its middle, and the host operation (not a span) that overlaps it most."""
    s, e = gap
    mid = (s + e) // 2
    where = "outside spans"
    for name, _, hs, hd in spans:
        if hs <= mid < hs + hd:
            where = name
    best, best_ov = "", 0
    for name, _, hs, hd in host:
        if name.startswith(SPAN_PREFIX):
            continue
        ov = min(e, hs + hd) - max(s, hs)
        if ov > best_ov:
            best, best_ov = name, ov
    return f"{where}: {best}" if best else where
