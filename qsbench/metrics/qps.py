"""qps: every query completed in the window over the window's seconds."""


def read(run):
    return len(run.completed()) / run.seconds
