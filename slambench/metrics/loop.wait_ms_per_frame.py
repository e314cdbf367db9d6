"""loop.wait_ms_per_frame (ms): the program's span `retire_wait` (the wait
on the event behind a batch's diagnostics), the growth of
`system.retire_host_s["retire_wait"]` over the window, over the window's
calls; nothing where the program has no such span."""


def read(run):
    w = run.window
    key = "retire_wait"
    if not w.spans or key not in w.counters_open or key not in w.counters_close:
        return None
    return 1e3 * (w.counters_close[key] - w.counters_open[key]) / len(w.spans)
