"""Host ms a round in the scheduler's ``round.select`` span (tiering,
CSTT selection, the delays and the straggler lane; in the semi-async
loop also the snapshots' scatter), over the window's rounds."""


def read(trace):
    return trace.per_round_ms({"round.select"}, device=False)
