"""% of its bound that the elementwise family's kernels reach (roofline.share)."""

from portbench import roofline


def read(t):
    return roofline.share(t, "elementwise")
