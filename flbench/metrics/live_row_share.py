"""Client rows that are live updates, in % of the rows the trainer
trains (the engine pads a cohort to a power of two with copies of its
last client and trains them too), over the window's rounds."""


def read(trace):
    live = sum(c["live"] for r in trace.rounds for c in r["calls"])
    rows = sum(c["rows"] for r in trace.rounds for c in r["calls"])
    return 100.0 * live / rows if rows else None
