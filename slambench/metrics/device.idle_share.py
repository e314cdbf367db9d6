"""device.idle_share (%): 1 - the device's busy time per frame in the
traced window (`device.busy_ms_per_frame`) over the untraced window's wall
time per delivered frame. The traced window's own length is not the base:
the profiler slows the host's graph launches about threefold, so the idle
share inside it measures the profiler."""


def read(run):
    t, w = run.trace, run.window
    if t is None or not t.states or not t.device or not w.retired_in_window:
        return None
    return 100.0 * (1.0 - (t.busy_s / len(t.states)) / (w.seconds / w.retired_in_window))
