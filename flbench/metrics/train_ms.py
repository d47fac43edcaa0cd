"""Device ms a round of cohort training: ``round.train`` (sync) or
``window.train`` (async), between the CUDA events at each end of the
span, over the window's rounds."""


def read(trace):
    name = ("round.train" if trace.traffic["method"] == "feddct"
            else "window.train")
    return trace.per_round_ms({name}, device=True)
