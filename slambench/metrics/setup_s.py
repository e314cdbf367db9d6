"""setup_s (s): from the harness's start to the window's opening: imports,
the program's build and load, the ring's rendering, the system, its graph
captures and the warm-up frames."""


def read(run):
    return run.setup_s
