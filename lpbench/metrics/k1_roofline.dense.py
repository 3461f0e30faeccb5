"""``k1_roofline.dense``: K1 (``csrc/pivot_update.cu``: its gather and
apply kernels) against its bound over the window: every pivot reads and
writes the whole tableau once (``roofline.k1_pivot_bytes``)."""
from lpbench import roofline
from lpbench.metrics._common import device_s


def read(record):
    total = 0.0
    for c in record["calls"]:
        n = c["notes"]
        if c["traced"] and "tableau" in n:
            R, W, itemsize = n["tableau"]
            nbytes, flops = roofline.k1_pivot_bytes(R, W, itemsize)
            total += roofline.bound_s(n["pivots"] * nbytes,
                                      n["pivots"] * flops)[0]
    dev = device_s(record, "pivot_gather_kernel", "pivot_apply_kernel")
    return roofline.share_pct(total, dev) if total > 0 else None
