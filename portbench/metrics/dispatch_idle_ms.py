"""Device-idle ms a request (the gaps between the card's kernels, copies
and fills) that fall inside the union of the program's `aloha.*` spans:
the card waiting on the program, not on the harness."""

from portbench import spans


def read(t):
    return spans.idle_covered_ms(t)
