"""Host ms a request covered by the union of the program's `aloha.*` spans
(`aloha_tpu_torch.profiling.span`): the program's time to enqueue a
request, the harness's own time left out."""

from portbench import spans


def read(t):
    return spans.covered_ms(t)
