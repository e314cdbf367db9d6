"""step.track_ms_per_frame (ms): the mean over the frames retired in the
window of `FrameState.step_ms["track"]`, the device milliseconds of the
megastep's coarse-to-fine LM tracking between its two clock stamps; nothing
where no state carries it."""


def read(run):
    seen = [s.step_ms["track"] for s in run.window.retired
            if "track" in (getattr(s, "step_ms", None) or {})]
    return sum(seen) / len(seen) if seen else None
