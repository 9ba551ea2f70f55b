"""Model FLOPs of the tokens the window processed (prompt tokens admitted
and output tokens decoded: 2 N_active each, plus attention over their
query-key pairs) over the window and the H100's bf16 peak, in %."""
from portbench.yardstick import costs


def read(rec):
    if rec.get("loop") != "serve":
        return None
    return costs.mfu_percent(rec["model_flops"], rec["host_window_s"],
                             rec["chips"])
