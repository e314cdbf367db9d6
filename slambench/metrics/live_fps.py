"""live_fps (frames/s): poses delivered in the window over its seconds."""


def read(run):
    w = run.window
    return w.retired_in_window / w.seconds if w.seconds > 0 else None
