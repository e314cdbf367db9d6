"""boot.uniforms_host_ms_per_frame (ms): the program's span
`ransac_uniforms` (the host's draw of a frame's RANSAC uniforms from its
seeded generator and their pinned upload), the growth of
`system.retire_host_s["ransac_uniforms"]` over the window, over the
window's calls; nothing where the program has no such span."""

KEY = "ransac_uniforms"


def read(run):
    w = run.window
    if not w.spans or KEY not in w.counters_close:
        return None
    return 1e3 * (w.counters_close[KEY] - w.counters_open.get(KEY, 0.0)) / len(w.spans)
