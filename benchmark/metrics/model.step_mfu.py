"""model.step_mfu: model FLOPs of a step (6 per weight per token) over
step_ms, over the card's fp32 peak outside the tensor cores (the
configuration computes with TF32 off), percent."""


def read(rec):
    walls = rec.get("step_walls")
    if rec.get("kind") != "train" or not walls or "peaks" not in rec:
        return None
    step_s = rec["window_s"] / len(walls)
    return 100.0 * rec["flops_per_step"] / step_s / rec["peaks"]["fp32_flops"]
