"""The LM update after an evaluation in one launch
(`csrc/lm_step.cu:uws_lm_step`), and the state it updates.

`tracking.photometric` runs a level's Levenberg-Marquardt loop as an
evaluation and an update per iteration. With Huber weights or none the
evaluation is one `lm_evaluate` launch (`ops.cuda_track`), which leaves the
candidate's sums in the evaluator's output; on a card the update is one
`lm_step` launch that reads those sums and updates the B pairs' `LMLoop` in
place: the accept test, the damped solve, the pose (and brightness) update,
the stopping test, committed only for pairs still iterating. The plain
version is `tracking.photometric.lm_step` (with `lm_start` for the init form),
the one Python copy of the update, which the CPU runs; a CPU tensor given
here raises.

`lm_step_init` allocates the state and runs the init form; `lm_step` then
updates it in place, so nothing reads the card and a CUDA graph captures the
level as it is. `lm_step.launches` counts both forms' launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib
from .cuda_track import lm_layout



class LMLoop(NamedTuple):
    """The LM loop's state between iterations, pair dimension first."""
    T: torch.Tensor           # (B, 4, 4) the candidate to evaluate next
    ab: torch.Tensor          # (B, 2) its brightness (a, b); the level's ab0 unless affine
    T_best: torch.Tensor      # (B, 4, 4) the best accepted pose
    ab_best: torch.Tensor     # (B, 2) its brightness
    s_best: tuple             # what the solve needs at the best state: (sums,) when fused
    error: torch.Tensor       # (B,) its robust error
    lam: torch.Tensor         # (B,) the damping
    k: torch.Tensor           # (B,) int64 iterations run
    done: torch.Tensor        # (B,) bool
    n_inlier: torch.Tensor    # (B,) int64 valid count at the best state


def _on_card(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError("lm_step runs on a card; on the CPU the update is "
                         "tracking.photometric.lm_step")


def _check(loop: LMLoop, sums: torch.Tensor, affine: bool) -> None:
    dev = sums.device
    _on_card(dev)
    B, width = loop.T.shape[0], lm_layout(affine).width
    _lib.require(sums, "sums", (B, width), dev)
    (s_best,) = loop.s_best
    _lib.require(s_best, "s_best", (B, width), dev)
    for name in ("T", "T_best"):
        _lib.require(getattr(loop, name), name, (B, 4, 4), dev)
    if affine:
        for name in ("ab", "ab_best"):
            _lib.require(getattr(loop, name), name, (B, 2), dev)
    for name in ("error", "lam"):
        _lib.require(getattr(loop, name), name, (B,), dev)
    for name in ("k", "n_inlier"):
        _lib.require(getattr(loop, name), name, (B,), dev, dtype=torch.int64)
    _lib.require(loop.done, "done", (B,), dev, dtype=torch.bool)


def _launch(loop: LMLoop, sums, affine: bool, max_iters: int = 0, eps: float = 0.0,
            init_lambda: float = 0.0, T0=None, ab0=None) -> None:
    """One `uws_lm_step` launch: the init form where T0 is given."""
    def ptr(t, used: bool = True) -> int:
        return t.data_ptr() if used and t is not None else 0

    _lib.launch("uws_lm_step", sums.device, sums.data_ptr(), loop.T.data_ptr(),
                ptr(loop.ab, affine), loop.T_best.data_ptr(), ptr(loop.ab_best, affine),
                loop.s_best[0].data_ptr(), loop.error.data_ptr(), loop.lam.data_ptr(),
                loop.k.data_ptr(), loop.done.data_ptr(), loop.n_inlier.data_ptr(),
                ptr(T0), ptr(ab0, affine), loop.T.shape[0], int(affine), max_iters, eps,
                init_lambda, int(T0 is not None))
    lm_step.launches += 1


def lm_step_init(sums: torch.Tensor, T0: torch.Tensor, ab0: torch.Tensor,
                 init_lambda: float, affine: bool) -> LMLoop:
    """The init form: a fresh `LMLoop` of B pairs on the card from the first
    evaluation's sums (B, 48), or (B, 80) with affine brightness, at the
    level's initial poses T0 (B, 4, 4) and brightness ab0 (B, 2): lam =
    init_lambda, the best state (T0, ab0, a copy of the sums), and the first
    candidate from the damped step. Without affine, `ab` and `ab_best` are
    ab0 itself and stay so."""
    dev, B = sums.device, T0.shape[0]
    _on_card(dev)
    _lib.require(T0, "T0", (B, 4, 4), dev)
    if affine:
        _lib.require(ab0, "ab0", (B, 2), dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    loop = LMLoop(T=empty(B, 4, 4), ab=empty(B, 2) if affine else ab0, T_best=empty(B, 4, 4),
                  ab_best=empty(B, 2) if affine else ab0,
                  s_best=(empty(B, lm_layout(affine).width),), error=empty(B), lam=empty(B),
                  k=empty(B, dtype=torch.int64), done=empty(B, dtype=torch.bool),
                  n_inlier=empty(B, dtype=torch.int64))
    _check(loop, sums, affine)
    _launch(loop, sums, affine, init_lambda=init_lambda, T0=T0, ab0=ab0)
    return loop


def lm_step(loop: LMLoop, sums: torch.Tensor, max_iters: int, eps: float) -> None:
    """One LM update of `loop`'s pairs on the card, in place, from the sums
    of the evaluation at (loop.T, loop.ab); affine when the sums are 80 wide."""
    affine = sums.shape[-1] == lm_layout(True).width
    _check(loop, sums, affine)
    _launch(loop, sums, affine, max_iters, eps)


lm_step.launches = 0
