"""setup_s: from the harness's start to the window's: the kernels' build
or load, the tables made and handed over, the cell's queries run once."""


def read(run):
    return run.setup_s
