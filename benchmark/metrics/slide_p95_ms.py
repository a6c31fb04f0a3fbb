"""95th percentile of a slide's time in the traced run, in milliseconds:
hand-in to genes on the host, over the window's slides that ran after the
profiler session closed (those inside it run at the profiler's pace), each
still timed through the benchmark's spans and their synchronises.  The
untraced runs' tail swings with the host's speed by more than any bound can
hold, so it is read here, beside ``slides_per_hour``, and not held to a
bound.

Layer: serving; source: host_clock; unit: ms, lower is better;
moves slides_per_hour."""

from benchmark import common


def read(rec: dict):
    lat = rec.get("slide_s")
    return 1e3 * common.quantile(lat, 0.95) if lat else None
