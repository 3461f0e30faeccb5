"""``k2_roofline.classic``: K2 (``csrc/fused_pivot_step.cu``) against its
bound over the window, from the instances' pivot counts."""
from lpbench.metrics._batched_roofline import share


def read(record):
    return share(record, False, "fused_pivot_step_kernel")
