"""% of its bound that the ntt family's kernels reach (roofline.share)."""

from portbench import roofline


def read(t):
    return roofline.share(t, "ntt")
