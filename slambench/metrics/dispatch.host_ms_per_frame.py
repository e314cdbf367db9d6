"""dispatch.host_ms_per_frame (ms): the program's span `dispatch` (a frame's
megastep handed to the card: the inputs' copy-in, the graph replay and the
output clones), the growth of `system.retire_host_s["dispatch"]` over the
window, over the window's calls; nothing where the program has no such
span."""


def read(run):
    w = run.window
    key = "dispatch"
    if not w.spans or key not in w.counters_open or key not in w.counters_close:
        return None
    return 1e3 * (w.counters_close[key] - w.counters_open[key]) / len(w.spans)
