"""Batch elements answered (an encrypted vector, or a vector pair) over the
window's time, counting every request completed in it."""


def read(w):
    return w.vectors / w.seconds
