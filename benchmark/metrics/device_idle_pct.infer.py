"""The device's idle share over the traced slides: one less the union of
the intervals in which a device operation ran, over the traced window.

Layer: device; source: device_trace; unit: %, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
