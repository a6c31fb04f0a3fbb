"""The train step's share of the card's f32 peak outside the tensor cores
(67 TFLOP/s: the configuration trains in IEEE f32, TF32 off): the ViS
step's matmul FLOPs (a copy of ``bench._vis_train_flops``) times the steps
in the traced epochs, over the traced window times that peak.

Layer: train step; source: device_trace; unit: %, higher is better;
moves train_slides_per_s."""

from benchmark import arith


def read(rec: dict):
    tr = rec.get("trace")
    steps = rec["items"].get("steps_traced", 0)
    if not tr or tr["busy_s"] <= 0 or not steps:
        return None
    return 100.0 * steps * rec["step_flops"] / (tr["window_s"] * arith.PEAK_FLOPS["float32"])
