"""Kernels the trace shows a request: the host's dispatch of the he_torch ops
and the ops/ wrappers, as a count."""


def read(t):
    return len(t.kernels) / t.requests if t.kernels else None
