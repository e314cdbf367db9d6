"""Descriptor matching: brute-force kNN + ratio and symmetry tests.

Counterpart of `uwslam_tpu.features.match.match_descriptors`. The JAX
package rounds both descriptor sets to bf16 on every backend and
accumulates their product in f32; here the inputs are rounded to bf16 and
back to f32 and multiplied in f32 (products of bf16 values are exact in
f32), so CPU and card differ only in the order of the f32 sums. Top-2
selection breaks ties toward the lower index, as `lax.top_k` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

RATIO = 0.65


class Matches(NamedTuple):
    idx_a: torch.Tensor   # (K,) int64 index into keypoint set A
    idx_b: torch.Tensor   # (K,) int64 index into keypoint set B
    score: torch.Tensor   # (K,) similarity of the accepted pair
    valid: torch.Tensor   # (K,) bool


def _ratio_test_dir(sim, valid_a, valid_b, ratio: float):
    """Per-row best and second best with the L2 ratio test on cosine
    similarities of unit descriptors: (1 - s1) < r^2 (1 - s2)."""
    masked = torch.where(valid_b[None, :], sim, -torch.inf)
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :2]
    top2 = masked.gather(-1, order)
    s1, s2 = top2[:, 0], top2[:, 1]
    pass_ratio = (1.0 - s1) < (ratio * ratio) * (1.0 - s2)
    ok = valid_a & torch.isfinite(s1) & torch.isfinite(s2) & pass_ratio
    return order[:, 0], s1, ok


def match_descriptors(desc_a, desc_b, valid_a, valid_b, ratio: float = RATIO) -> Matches:
    """Bidirectional ratio-tested mutual matching of (K_a, D) and (K_b, D)
    descriptors. Capacity K_a."""
    a = desc_a.to(torch.bfloat16).float()
    b = desc_b.to(torch.bfloat16).float()
    sim = a @ b.T
    best_ab, s_ab, ok_ab = _ratio_test_dir(sim, valid_a, valid_b, ratio)
    best_ba, _, ok_ba = _ratio_test_dir(sim.T, valid_b, valid_a, ratio)
    idx_a = torch.arange(desc_a.shape[0], device=desc_a.device)
    mutual = best_ba[best_ab] == idx_a
    return Matches(idx_a=idx_a, idx_b=best_ab, score=s_ab,
                   valid=ok_ab & mutual & ok_ba[best_ab])
