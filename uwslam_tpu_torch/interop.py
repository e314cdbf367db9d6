"""Carry state from the JAX package into the port.

Each function takes the JAX package's object (or its fields) as numpy
arrays and plain numbers and returns the port's counterpart, so both
packages can compute on identical inputs. Nothing here imports JAX: a
caller holding JAX arrays passes them through `numpy.asarray`, which these
functions apply to every field.
"""
from __future__ import annotations

import numpy as np
import torch

from .ba.photometric import PhotoBAProblem
from .ba.pose_graph import PoseGraph, Sim3PoseGraph
from .ba.schur import BAProblem
from .camera.model import PinholeCamera
from .features.detect import Keypoints
from .image.pyramid import FramePyramid
from .map.loop_closure import KeyframeRecord, LoopEdge
from .tracking.depth_prior import DepthPrior
from .tracking.points import TrackPoints
from .utils.synthetic import FractalTexture, Texture


def _tensor(x, device, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def camera_from_jax(cam) -> PinholeCamera:
    """From an object with the fields of `uwslam_tpu.camera.PinholeCamera`,
    the radtan coefficients included."""
    return PinholeCamera(
        fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
        width=int(cam.width), height=int(cam.height),
        **{k: float(getattr(cam, k, 0.0)) for k in ("k1", "k2", "p1", "p2")},
    )


def depth_from_numpy(depth, device) -> torch.Tensor:
    """A depth image (H, W), or a stack of them, in raw sensor units (TUM:
    16-bit, 5000 per metre) as f32 on `device`; 16-bit values are exact."""
    return _tensor(depth, device)


def pyramid_from_numpy(pyr, device) -> FramePyramid:
    """From an object with the fields of `uwslam_tpu.image.FramePyramid`
    (images, grad_x, grad_y, grad_mag: one (B, H_l, W_l) array per level)."""
    return FramePyramid(
        *(tuple(_tensor(x, device) for x in getattr(pyr, f))
          for f in FramePyramid._fields)
    )


def points_from_numpy(pts, device) -> TrackPoints:
    """From an object with the fields of `uwslam_tpu.tracking.TrackPoints`
    ((B, N, ...) arrays; gx0/gy0 may be None)."""
    def opt(x):
        return None if x is None else _tensor(x, device)

    return TrackPoints(
        uv=_tensor(pts.uv, device),
        p3d=_tensor(pts.p3d, device),
        intensity=_tensor(pts.intensity, device),
        valid=_tensor(pts.valid, device, dtype=bool),
        gx0=opt(pts.gx0),
        gy0=opt(pts.gy0),
    )


def descriptor_projection_from_numpy(m, device) -> torch.Tensor:
    """The (64, 64) descriptor projection as the port's `describe` takes it
    (`proj=`), from the JAX package's `_projection_matrix(64, 64)`."""
    t = _tensor(m, device)
    if tuple(t.shape) != (64, 64):
        raise ValueError(f"descriptor projection must be (64, 64), got {tuple(t.shape)}")
    return t


def texture_from_numpy(freqs, phases, amps) -> Texture:
    """Sinusoid coefficients (12, 2), (12,), (12,) of a smooth texture."""
    return Texture(
        freqs=np.asarray(freqs, np.float32),
        phases=np.asarray(phases, np.float32),
        amps=np.asarray(amps, np.float32),
    )


def fractal_texture_from_numpy(freqs, phases, amps, octaves: int) -> FractalTexture:
    """Sinusoid coefficients (4 octaves, 2), (4 octaves,), (4 octaves,) of a
    broadband texture, octave by octave, amplitudes with their 0.55^o."""
    return FractalTexture(
        freqs=np.asarray(freqs, np.float32).reshape(-1, 2),
        phases=np.asarray(phases, np.float32).reshape(-1),
        amps=np.asarray(amps, np.float32).reshape(-1),
        octaves=int(octaves),
    )


def ba_problem_from_numpy(problem, device) -> BAProblem:
    """From an object with the fields of `uwslam_tpu.ba.BAProblem`; the index
    fields become int64 (what tensor indexing takes)."""
    return BAProblem(
        T_cw=_tensor(problem.T_cw, device),
        points=_tensor(problem.points, device),
        obs_kf=_tensor(problem.obs_kf, device, dtype=np.int64),
        obs_lm=_tensor(problem.obs_lm, device, dtype=np.int64),
        obs_uv=_tensor(problem.obs_uv, device),
        obs_valid=_tensor(problem.obs_valid, device, dtype=bool),
    )


def photo_ba_problem_from_numpy(problem, device) -> PhotoBAProblem:
    """From an object with the fields of `uwslam_tpu.ba.PhotoBAProblem`."""
    return PhotoBAProblem(**{
        f: _tensor(getattr(problem, f), device, dtype=bool if f == "valid" else np.float32)
        for f in PhotoBAProblem._fields
    })


def depth_prior_from_numpy(prior, device) -> DepthPrior:
    """From an object with the fields of
    `uwslam_tpu.tracking.depth_prior.DepthPrior` (inv_depth, weight, block)."""
    return DepthPrior(
        inv_depth=_tensor(prior.inv_depth, device),
        weight=_tensor(prior.weight, device),
        block=int(prior.block),
    )


def keypoints_from_numpy(kps, device) -> Keypoints:
    """From an object with the fields of `uwslam_tpu.features.Keypoints`."""
    return Keypoints(**{
        f: _tensor(getattr(kps, f), device,
                   dtype={"valid": bool, "level": np.int32}.get(f, np.float32))
        for f in Keypoints._fields
    })


def pose_graph_from_numpy(graph, device, sim3: bool = False):
    """From an object with the fields of `uwslam_tpu.ba.PoseGraph` (or, with
    `sim3`, of `uwslam_tpu.ba.Sim3PoseGraph`), in their order: poses, edge
    i and j, measurements, weights, valid."""
    dtypes = (np.float32, np.int32, np.int32, np.float32, np.float32, bool)
    cls = Sim3PoseGraph if sim3 else PoseGraph
    return cls(*(_tensor(x, device, dtype=d) for x, d in zip(graph, dtypes)))


def keyframe_records_from_numpy(records, device) -> list[KeyframeRecord]:
    """From objects with the fields of `uwslam_tpu.map.loop_closure.
    KeyframeRecord`: the keypoint fields on `device`, pose and global
    descriptor on the host."""
    return [KeyframeRecord(
        frame_id=int(r.frame_id), T_wc=np.array(r.T_wc, np.float32),
        kp_uv=_tensor(r.kp_uv, device), kp_desc=_tensor(r.kp_desc, device),
        kp_valid=_tensor(r.kp_valid, device, dtype=bool), kp_p3d=_tensor(r.kp_p3d, device),
        global_desc=np.array(r.global_desc, np.float32),
    ) for r in records]


def loop_edge_from_numpy(edge) -> LoopEdge:
    """From an object with the fields of `uwslam_tpu.map.loop_closure.LoopEdge`."""
    return LoopEdge(i=int(edge.i), j=int(edge.j), T_ij=np.array(edge.T_ij, np.float32),
                    num_inliers=int(edge.num_inliers), scale=float(edge.scale))
