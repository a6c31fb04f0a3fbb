"""The folds' share of their roofline: five ViS forwards of one slide's
(1, 100, D) cluster features (blocks in the serving dtype, the gene head
in f32; each fold's weights read once) over the device time inside the
fold spans.

Layer: folds; source: device_trace; unit: %, higher is better;
moves slides_per_hour."""

from benchmark import arith


def read(rec: dict):
    t = (rec.get("trace") or {}).get("span_device_s", {}).get("folds")
    work = rec.get("work", {}).get("folds")
    return 100.0 * arith.bound_s(*work) / t if t and work else None
