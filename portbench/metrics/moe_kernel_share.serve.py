"""The port's MoE kernels' device time (the expert MLP forward, its dgrad,
wgrad, recompute and reduce passes, the GroupGEMM and the top-k combine)
over the device's busy time in the window, in %."""
from portbench.yardstick import kernels as K


def read(rec):
    return K.share_of_busy(rec, K.MOE_GROUPS)
