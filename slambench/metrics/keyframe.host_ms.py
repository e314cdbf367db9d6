"""keyframe.host_ms (ms): the program's counter
`system.retire_host_s["make_keyframe"]` over the window, per keyframe made
in it (`FrameState.is_keyframe` of the poses delivered in the window);
nothing where the window made none."""


def read(run):
    w = run.window
    made = sum(1 for s in w.retired if s.is_keyframe)
    if not made:
        return None
    spent = w.counters_close["make_keyframe"] - w.counters_open["make_keyframe"]
    return 1e3 * spent / made
