"""The backbone's share of its roofline: the least time of the traced
slides' backbone work (the model's FLOPs from its shapes over the compute
dtype's peak, or its bytes over the bandwidth, whichever is longer) over the
device time of the operations inside the backbone spans, copies left out.

Layer: backbone; source: device_trace; unit: %, higher is better;
moves slides_per_hour."""

from benchmark import arith


def read(rec: dict):
    t = (rec.get("trace") or {}).get("span_device_s", {}).get("backbone")
    work = rec.get("work", {}).get("backbone")
    return 100.0 * arith.bound_s(*work) / t if t and work else None
