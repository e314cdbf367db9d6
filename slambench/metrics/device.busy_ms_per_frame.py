"""device.busy_ms_per_frame (ms): the union of the device's kernel, copy and
fill intervals in the traced window, over the frames retired in it."""


def read(run):
    t = run.trace
    if t is None or not t.states or not t.device:
        return None
    return 1e3 * t.busy_s / len(t.states)
