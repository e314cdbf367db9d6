"""step.device_ms_per_frame (ms): the mean over the frames retired in the
window of the sum of `FrameState.step_ms`, the device milliseconds between
the first and the last clock stamp of the frame's megastep, taken inside
its graph replay with no profiler; nothing where no state carries them."""


def read(run):
    seen = [sum(s.step_ms.values()) for s in run.window.retired
            if getattr(s, "step_ms", None)]
    return sum(seen) / len(seen) if seen else None
