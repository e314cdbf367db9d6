"""boot.match_ms_per_frame (ms): the mean over the frames retired in the
window of `FrameState.step_ms["match"]`, the device milliseconds of the
bootstrap megastep's `match` stage between its two clock stamps; nothing
where no state carries it (a frame of the plain megastep, or of the
synchronous path)."""

STAGE = "match"


def read(run):
    seen = [s.step_ms[STAGE] for s in run.window.retired
            if STAGE in (getattr(s, "step_ms", None) or {})]
    return sum(seen) / len(seen) if seen else None
