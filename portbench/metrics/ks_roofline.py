"""% of its bound that the ks family's kernels reach (roofline.share)."""

from portbench import roofline


def read(t):
    return roofline.share(t, "ks")
