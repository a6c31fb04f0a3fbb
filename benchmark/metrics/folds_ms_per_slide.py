"""Fold milliseconds a slide: the benchmark's span around
``SlidePredictor.predict_cluster_features`` (five ViS folds, K1 where it
takes them, the mean and the readback of the genes).

Layer: folds; source: program_span; unit: ms, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    ms = rec["spans"].get("folds")
    return sum(ms) / len(ms) if ms else None
