"""step.kernels_per_frame (kernels): kernel records of the traced window
over the frames retired in it."""


def read(run):
    t = run.trace
    if t is None or not t.states or not t.kernels:
        return None
    return len(t.kernels) / len(t.states)
