"""retire.frames_in_flight (frames): the mean over the frames retired in the
window of `FrameState.in_flight`, the frames dispatched and not yet retired
when the frame retired, itself included; nothing where no state carries it."""


def read(run):
    seen = [s.in_flight for s in run.window.retired if getattr(s, "in_flight", None) is not None]
    return sum(seen) / len(seen) if seen else None
