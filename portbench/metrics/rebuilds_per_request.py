"""`aloha.build.*` spans a request: twiddle or kernel tables, gather maps,
prepared keys or the kernel library built again inside the traced
requests (none once set-up has warmed every cache)."""

from portbench import spans


def read(t):
    return spans.count_per_request(t, spans.BUILD)
