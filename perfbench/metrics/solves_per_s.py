"""Lane solves completed over the window: every lane of every call, over
the time from the first call's start to the last one's end.  Host clock
around calls that end in a synchronisation."""


def read(run):
    return sum(len(c.steps) for c in run.calls) / run.window_s
