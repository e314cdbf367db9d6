"""pose_latency_ms_p95 (ms): the 95th percentile, over every frame handed
over in the window, of the time from its hand-off to `process_frame_async`
until its FrameState is in `system.trajectory`."""
from slambench.stats import percentile


def read(run):
    w = run.window
    return 1e3 * percentile([w.delivered[k] - t for k, t in w.handed.items()], 95)
