"""Backbone milliseconds per thousand patches: the benchmark's span around
``extractor.features`` (CUDA work ended by a synchronise), over all slides
of the traced run's window.

Layer: backbone; source: program_span; unit: ms, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    ms = rec["spans"].get("backbone")
    k = rec["items"].get("patches", 0) / 1000.0
    return sum(ms) / k if ms and k else None
