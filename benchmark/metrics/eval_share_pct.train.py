"""The validation phase's share of the window: from the marks that
``loop.train``'s ``log_fn`` gives at the end of each phase (each after the
phase's metrics came to the host, so after its device work).

Layer: train loop phases; source: host_clock; unit: %, lower is better;
moves train_slides_per_s."""


def read(rec: dict):
    m = rec.get("marks")
    if not m or m["window_s"] <= 0:
        return None
    return 100.0 * m["val_s"] / m["window_s"]
