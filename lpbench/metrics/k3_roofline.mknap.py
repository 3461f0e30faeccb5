"""``k3_roofline.mknap``: K3 (``csrc/fused_pivot_step_bounded.cu``)
against its bound over the window, each instance's bound flips charged as
flips and its other steps as pivots (``_flip_roofline.py``): the float32
solve loop's launches; the float64 finish's are left out, bytes and time
alike."""
from lpbench.metrics._flip_roofline import share


def read(record):
    return share(record)
