"""Model FLOPs of the window's training tokens (6 N_active a token plus
attention's causal pairs, ``yardstick/costs.train_flops``) over the
window's length, the chips and the H100's 989 TFLOP/s bf16 peak, in %."""
from portbench.yardstick import costs


def read(rec):
    if rec.get("loop") != "train":
        return None
    return costs.mfu_percent(rec["model_flops"], rec["host_window_s"],
                             rec["chips"])
