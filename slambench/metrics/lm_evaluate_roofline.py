"""lm_evaluate_roofline (%): the least time one `lm_evaluate` launch could
take, its bytes (counted from the shapes: the frame's points, the valid
ones taken as the mean inlier count of the traced frames) over the card's
HBM rate, as a share of the mean launch's time in the traced window."""
from slambench.roofline import lm_evaluate_bytes, peak


def read(run):
    t = run.trace
    times = [e - s for name, s, e in t.kernels if "lm_evaluate_kernel" in name] if t else []
    if not times or not t.states:
        return None
    valid = sum(s.tracked_inliers for s in t.states) / len(t.states)
    n_bytes = lm_evaluate_bytes(run.shape["num_points"], valid, run.shape["fc"],
                                run.shape["affine"])
    least = n_bytes / peak(run.device_kind)["hbm_bytes_per_s"]
    return 100.0 * least / (sum(times) / len(times))
