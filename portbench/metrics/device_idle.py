"""% of the traced window in which the card runs no kernel, copy or fill
(the union of their intervals, not the sum)."""


def read(t):
    return 100.0 * (1.0 - t.busy_us / t.window_us)
