"""``k3_roofline.bounded``: K3 (``csrc/fused_pivot_step_bounded.cu``)
against its bound over the window, from the instances' pivot counts; bound
flips are charged as stopping steps."""
from lpbench.metrics._batched_roofline import share


def read(record):
    return share(record, True, "fused_pivot_step_bounded_kernel")
