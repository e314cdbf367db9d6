"""retire.host_ms_per_frame (ms): the self time of the program's span
`retire` (one frame's retirement: failure gate, keyframe policy, trajectory
append; its children `keyframe` and `relocalize` left out), the growth of
`system.retire_host_s["retire.self"]` over the window, over the frames
retired in the window; nothing where the program has no such span."""

KEY = "retire.self"


def read(run):
    w = run.window
    if not w.retired or KEY not in w.counters_close:
        return None
    return 1e3 * (w.counters_close[KEY] - w.counters_open.get(KEY, 0.0)) / len(w.retired)
