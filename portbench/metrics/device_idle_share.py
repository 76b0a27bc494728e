"""1 − (device busy seconds a step in the traced stretch, the union of the
device operations' intervals) ÷ (seconds a step of the untraced window),
in percent: the idle share of the run as it goes without the profiler,
whose own tracing would leave the device idle longer."""


def read(view):
    if not view.ops or view.steps <= 0 or view.step_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.steps / view.step_s)
