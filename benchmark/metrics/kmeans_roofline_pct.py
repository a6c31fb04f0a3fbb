"""k-means' share of its roofline: the least time of the traced slides'
k-means in f32 (the seeding passes, the Lloyd steps that ``kmeans_fit``
reported as ``n_iter`` for these features, the final assignment and the
means; the features read once) over the device time inside the k-means
spans.

Layer: k-means; source: device_trace; unit: %, higher is better;
moves slides_per_hour."""

from benchmark import arith


def read(rec: dict):
    t = (rec.get("trace") or {}).get("span_device_s", {}).get("kmeans")
    work = rec.get("work", {}).get("kmeans")
    return 100.0 * arith.bound_s(*work) / t if t and work else None
