"""Host ms a request covered by the program's `aloha.rns.*` spans: the
Python and aten dispatch of the limb arithmetic (`rns_torch`'s addmod,
submod, mulmod, ... called from he_torch and the ops), which a fused
kernel would remove."""

from portbench import spans


def read(t):
    return spans.covered_ms(t, spans.RNS)
