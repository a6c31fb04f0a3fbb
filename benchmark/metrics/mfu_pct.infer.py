"""The whole slide's share of the card's bf16 peak (989 TFLOP/s): the model
FLOPs of the traced slides (backbone, k-means, five folds, from their
shapes) over the traced window times the peak.

Layer: whole slide; source: device_trace; unit: %, higher is better;
moves slides_per_hour."""

from benchmark import arith


def read(rec: dict):
    tr = rec.get("trace")
    work = rec.get("work", {})
    if not tr or tr["busy_s"] <= 0 or not work:
        return None
    flops = sum(sum(fl.values()) for fl, _ in work.values())
    return 100.0 * flops / (tr["window_s"] * arith.PEAK_FLOPS["bfloat16"])
