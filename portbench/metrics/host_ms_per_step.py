"""Host seconds of each ``step()`` call, without a synchronize, averaged
over the window's untraced steps, in ms: the MH step driver's enqueue
time (``sampling/mh.py``)."""


def read(view):
    return 1e3 * view.host_s_per_step
