"""pyramid_roofline (%): the least time one pyramid launch could take, its
bytes (level 0 read, every level's gradients and the coarser images
written, f32) over the card's HBM rate, as a share of the mean launch's
time in the traced window."""
from slambench.roofline import peak, pyramid_bytes


def read(run):
    t = run.trace
    times = [e - s for name, s, e in t.kernels if "pyramid_kernel" in name] if t else []
    if not times:
        return None
    n_bytes = pyramid_bytes(run.shape["height"], run.shape["width"], run.shape["levels"])
    least = n_bytes / peak(run.device_kind)["hbm_bytes_per_s"]
    return 100.0 * least / (sum(times) / len(times))
