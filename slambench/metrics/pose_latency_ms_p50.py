"""pose_latency_ms_p50 (ms): the median of the same stamps as
pose_latency_ms_p95."""
from slambench.stats import percentile


def read(run):
    w = run.window
    return 1e3 * percentile([w.delivered[k] - t for k, t in w.handed.items()], 50)
