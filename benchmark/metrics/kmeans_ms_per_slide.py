"""k-means milliseconds a slide: the benchmark's span around
``SlidePredictor.cluster`` (kmeans++ seeding, the Lloyd steps through K5,
the cluster means; ended by a synchronise), over the traced run's window.

Layer: k-means; source: program_span; unit: ms, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    ms = rec["spans"].get("kmeans")
    return sum(ms) / len(ms) if ms else None
