"""The MoE kernels' roofline share: the sum of each call's bound, priced
on the rows its inputs route and the experts they hit, over the device
time of those kernels in the window, in %."""
from portbench.yardstick import kernels as K


def read(rec):
    return K.moe_roofline(rec)
