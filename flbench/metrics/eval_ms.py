"""Host ms a round in ``eval`` (the global model's test accuracy and its
one readback, which waits for the round's device work), over the
window's rounds."""


def read(trace):
    return trace.per_round_ms({"eval"}, device=False)
