"""The share of the window in which no kernel runs on the device: the
window less the union of the kernels' intervals, in %."""
from portbench.yardstick import kernels as K


def read(rec):
    return K.idle_percent(rec)
