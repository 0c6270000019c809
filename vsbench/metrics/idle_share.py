"""Share of the traced window in which no operation runs on the device (the
reader of every ``idle_share.<mix>``)."""


def read(run):
    t = run.trace
    return 1.0 - t.busy_s / t.window_s if t and t.window_s > 0 else None
