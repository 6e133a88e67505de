"""device_idle_share: the share of the traced window in which no kernel,
copy or set ran on the card (torch.profiler), in %."""


def read(run):
    if run.busy_s is None or not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
