"""boot.graph_share (%): the share of the frames retired in the window
whose `FrameState.step_ms` carries the bootstrap megastep's `match` stage,
so frames that ran the bootstrap graph replay (the others took the
synchronous path: the init window after a loss, a recovery); nothing on a
CPU device, where no step is stamped, or for a window that retired none."""


def read(run):
    retired = run.window.retired
    if not retired or getattr(run, "device_kind", "cpu") == "cpu":
        return None
    boot = sum(1 for s in retired if "match" in (getattr(s, "step_ms", None) or {}))
    return 100.0 * boot / len(retired)
