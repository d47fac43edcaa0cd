"""Device ms a round in the async window step's store traffic:
``window.gather`` (the cohort's start rows) and ``window.merge_scatter``
(K2 and the scatter of the new global row), over the window's rounds."""


def read(trace):
    return trace.per_round_ms({"window.gather", "window.merge_scatter"},
                              device=True)
