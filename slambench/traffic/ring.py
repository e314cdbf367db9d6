"""The frames of a replay: one ring of rendered camera frames, made from the
seed, cycled for as long as a run lasts.

A frozen plain-PyTorch copy of the evaluation's synthetic TUM stand-in
(eval.py's `tum` scene of four occluding planes with broadband textures, its
smooth camera path with every frequency a multiple of 2 pi / period, its
gain and bias drift and its sensor noise). A mix file gives the parameters:

- `scene`: the scene file beside this module (`scene_tum.json`);
- `ring_frames` R and `path_period`: slot s of the ring is the view at path
  step s; R is a multiple of the period, so the ring closes on itself;
- `gain` / `bias`: {amp, harmonic, phase}: gain(s) = 1 + amp sin(2 pi h s / R
  + phase), bias(s) = amp sin(2 pi h s / R + phase), whole harmonics of the
  ring, so brightness is periodic in R too;
- `noise_sigma`: Gaussian sensor noise, one draw per slot from the seed;
- `stride`: frame k of the run shows slot (k * stride) mod R;
- `path`: the six twist sinusoids' amplitudes, phases and harmonics.

Frames are clipped to [0, 255] and truncated to 8 bits, as a camera driver
hands them over. Only the slots the stride visits are rendered.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


# ------------------------------------------------------------------ geometry

def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twists (..., 6) [v, w] -> (..., 4, 4): R = exp(w), t = V(w) v."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)
    small = theta2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, 1.0, theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - a) / torch.where(small, 1.0, theta2))
    W = _hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    T = torch.zeros(*xi.shape[:-1], 4, 4, dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def path_poses(steps: torch.Tensor, period: int, path: dict) -> torch.Tensor:
    """Camera-from-world poses (n, 4, 4) at path steps `steps` (n,): twist
    component j is amp_j sin(2 pi h_j s / period + phase_j) - amp_j sin(phase_j)."""
    w0 = 2.0 * math.pi / period
    s = steps.to(torch.float64)[:, None]
    amp = torch.tensor(path["amps"], dtype=torch.float64)
    ph = torch.tensor(path["phases"], dtype=torch.float64)
    h = torch.tensor(path["harmonics"], dtype=torch.float64)
    xi = amp * torch.sin(h * w0 * s + ph) - amp * torch.sin(ph)
    return se3_exp(xi.to(torch.float32))


def drift(slots: torch.Tensor, ring: int, spec: dict, offset: float) -> torch.Tensor:
    """offset + amp sin(2 pi h s / R + phase) per slot, in float64."""
    s = slots.to(torch.float64)
    return offset + spec["amp"] * torch.sin(2.0 * math.pi * spec["harmonic"] * s / ring
                                            + spec["phase"])


# -------------------------------------------------------------------- scene

def load_scene(name: str) -> dict:
    with open(HERE / f"{name}.json") as f:
        scene = json.load(f)
    for p in scene["planes"]:
        n = torch.tensor(p["normal"], dtype=torch.float64)
        n = n / n.norm()
        up = torch.tensor([0.0, 1.0, 0.0] if abs(float(n[1])) < 0.9 else [1.0, 0.0, 0.0],
                          dtype=torch.float64)
        e1 = torch.linalg.cross(up, n)
        e1 = e1 / e1.norm()
        p["e1"] = e1.to(torch.float32)
        p["e2"] = torch.linalg.cross(n, e1).to(torch.float32)
        p["p0"] = torch.tensor(p["center"], dtype=torch.float32)
    return scene


def _texture(x: torch.Tensor, y: torch.Tensor, plane: dict) -> torch.Tensor:
    """Broadband texture in [0, 255]: the sum of the plane's sinusoids,
    scaled by its static bound (every amplitude at most 0.55^octave)."""
    acc = torch.zeros_like(x)
    for (fx, fy), ph, a in zip(plane["freqs"], plane["phases"], plane["amps"]):
        acc = acc + a * torch.sin(fx * x + fy * y + ph)
    bound = sum(4 * (0.55 ** o) for o in range(plane["octaves"]))
    return (acc + bound) / (2.0 * bound) * 255.0


def render(cam: dict, T_cw: torch.Tensor, scene: dict) -> torch.Tensor:
    """Views (B, H, W) f32 of the scene from camera-from-world poses T_cw
    (B, 4, 4): the nearest plane each pixel's ray meets, shaded with that
    plane's texture at `texture_scale` x its in-plane coordinates; 0 where
    no plane is hit."""
    dev = T_cw.device
    H, W = cam["height"], cam["width"]
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    d = torch.stack([(u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"],
                     torch.ones_like(u)], -1)                     # (H, W, 3)
    R_wc = T_cw[:, :3, :3].transpose(1, 2)
    o = -(R_wc @ T_cw[:, :3, 3:])[..., 0]                         # (B, 3) centres
    d_w = torch.einsum("bij,hwj->bhwi", R_wc, d)
    B = T_cw.shape[0]
    t_best = torch.full((B, H, W), 1e9, device=dev)
    img = torch.zeros((B, H, W), device=dev)
    hit_any = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    k = scene["texture_scale"]
    for p in scene["planes"]:
        p0, e1, e2 = p["p0"].to(dev), p["e1"].to(dev), p["e2"].to(dev)
        n = torch.linalg.cross(e1, e2)
        denom = d_w @ n
        denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
        t = ((p0 - o) @ n)[:, None, None] / denom
        rel = o[:, None, None, :] + t[..., None] * d_w - p0
        s1, s2 = rel @ e1, rel @ e2
        inside = torch.ones_like(t, dtype=torch.bool)
        if p["extent"][0] > 0:
            inside &= s1.abs() <= p["extent"][0]
        if p["extent"][1] > 0:
            inside &= s2.abs() <= p["extent"][1]
        hit = (t > 1e-4) & inside & (t < t_best)
        t_best = torch.where(hit, t, t_best)
        img = torch.where(hit, _texture(s1 * k, s2 * k, p), img)
        hit_any |= hit
    return torch.where(hit_any, img, 0.0)


# --------------------------------------------------------------------- ring

def visited_slots(mix: dict) -> list[int]:
    """The ring slots a run visits, in the order it first visits them."""
    R, stride = mix["ring_frames"], mix["stride"]
    return list(range(0, R, math.gcd(R, stride)))


class Ring:
    """The rendered slots of a mix, as (S, H, W) uint8 on the host (pinned
    where there is a card): `frame(k)` is the host frame of run frame k,
    `slot_of(k)` its ring slot."""

    def __init__(self, frames: torch.Tensor, slots: list[int], mix: dict):
        self.frames = frames
        self.slots = slots
        self.mix = mix
        self._index = {s: i for i, s in enumerate(slots)}

    def slot_of(self, k: int) -> int:
        return (k * self.mix["stride"]) % self.mix["ring_frames"]

    def frame(self, k: int) -> torch.Tensor:
        return self.frames[self._index[self.slot_of(k)]]


def make_ring(mix: dict, cam: dict, seed: int, device, batch: int = 32) -> Ring:
    """Render the mix's visited slots on `device` in batches, add the drift
    and the seed's noise (one generator on the device, slot after slot),
    quantize to 8 bits and gather them on the host."""
    device = torch.device(device)
    scene = load_scene(mix["scene"])
    slots = visited_slots(mix)
    R = mix["ring_frames"]
    H, W = cam["height"], cam["width"]
    pinned = device.type == "cuda"
    out = torch.empty((len(slots), H, W), dtype=torch.uint8, pin_memory=pinned)
    gen = torch.Generator(device).manual_seed(int(seed))
    for i in range(0, len(slots), batch):
        s = torch.tensor(slots[i:i + batch])
        poses = path_poses(s % mix["path_period"], mix["path_period"], mix["path"]).to(device)
        gain = drift(s, R, mix["gain"], 1.0).to(torch.float32).to(device)
        bias = drift(s, R, mix["bias"], 0.0).to(torch.float32).to(device)
        img = render(cam, poses, scene) * gain[:, None, None] + bias[:, None, None]
        noise = torch.randn(img.shape, generator=gen, device=device)
        img = torch.clamp(img + mix["noise_sigma"] * noise, 0.0, 255.0)
        out[i:i + len(s)].copy_(img.to(torch.uint8))
    return Ring(out, slots, mix)
