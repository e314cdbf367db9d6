"""The ring of frames: periodic in pose, gain and bias, stride by stride,
and made from the seed alone."""
import json

import pytest
import torch

from slambench import spec
from slambench.traffic import ring

MIXES = ["replay", "replay_stride2"]


def _mix(name):
    return json.loads((spec.BENCH_DIR / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_ring_closes_on_itself_in_pose_gain_and_bias(name):
    mix = _mix(name)
    R, P = mix["ring_frames"], mix["path_period"]
    assert R % P == 0
    s = torch.arange(0, R, 7)
    a = ring.path_poses(s % P, P, mix["path"])
    b = ring.path_poses(s + R, P, mix["path"])     # a full turn of the ring later
    assert torch.allclose(a, b, atol=1e-6)
    for key, offset in (("gain", 1.0), ("bias", 0.0)):
        assert torch.allclose(ring.drift(s, R, mix[key], offset),
                              ring.drift(s + R, R, mix[key], offset), atol=1e-9)
    slots = ring.visited_slots(mix)
    assert len(slots) == R // mix["stride"]
    frames = ring.Ring(torch.zeros(len(slots), 1, 1, dtype=torch.uint8), slots, mix)
    turn = R // mix["stride"]
    assert all(frames.slot_of(k) == frames.slot_of(k + turn) for k in range(0, 3 * turn, 5))
    assert {frames.slot_of(k) for k in range(turn)} == set(slots)


def test_drift_is_the_evaluation_s_form():
    """gain 1 + 0.04 sin(2 pi 11 i / 640) and bias 3 sin(2 pi 7 i / 640 + 1):
    0.108 and 0.0687 rad per frame against eval.py's 0.11 and 0.07."""
    mix = _mix("replay")
    assert mix["gain"] == {"amp": 0.04, "harmonic": 11, "phase": 0.0}
    assert mix["bias"] == {"amp": 3.0, "harmonic": 7, "phase": 1.0}
    g = ring.drift(torch.tensor([10]), 640, mix["gain"], 1.0)
    assert float(g) == pytest.approx(1.0 + 0.04 * torch.sin(torch.tensor(2 * torch.pi * 110 / 640,
                                                                          dtype=torch.float64)))


def _tiny_cam():
    return {"fx": 52.5, "fy": 52.5, "cx": 31.5, "cy": 23.5, "width": 64, "height": 48}


def test_frames_come_from_the_seed_alone():
    mix = dict(_mix("replay_stride2"), ring_frames=16, path_period=8)
    a = ring.make_ring(mix, _tiny_cam(), 2**31 + 11, "cpu")
    b = ring.make_ring(mix, _tiny_cam(), 2**31 + 11, "cpu")
    c = ring.make_ring(mix, _tiny_cam(), 2**31 + 12, "cpu")
    assert a.frames.dtype == torch.uint8 and a.frames.shape == (8, 48, 64)
    assert torch.equal(a.frames, b.frames)
    assert not torch.equal(a.frames, c.frames)
    # the noise is all that differs between seeds: sigma 1.5 around the same view
    diff = a.frames.float() - c.frames.float()
    assert 1.0 < float(diff.std()) < 3.0


def test_render_sees_every_plane_of_the_scene():
    mix = _mix("replay")
    scene = ring.load_scene(mix["scene"])
    cam = {"fx": 131.25, "fy": 131.25, "cx": 79.5, "cy": 59.5, "width": 160, "height": 120}
    img = ring.render(cam, ring.path_poses(torch.tensor([0]), 160, mix["path"]), scene)
    assert img.shape == (1, 120, 160)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 255.0
    assert float(img.std()) > 10.0   # textured, not blank
