"""Device ms a round in ``round.aggregate`` (flattening the stacked
cohort, K1 and the all-masked guard), over the window's rounds."""


def read(trace):
    return trace.per_round_ms({"round.aggregate"}, device=True)
