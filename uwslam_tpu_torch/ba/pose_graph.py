"""Pose-graph optimization over SE(3) and Sim(3), in PyTorch.

Counterpart of `uwslam_tpu.ba.pose_graph`: a fixed-capacity edge table (i,
j, measured T_ij, weight, valid), residual log(T_ij^-1 T_i^-1 T_j) per edge
at the retracted poses T_i exp(delta_i), one dense Gauss-Newton system under
Levenberg-Marquardt with node 0 as the gauge anchor (in Sim(3) it also fixes
the global scale). The graph is small (tens to hundreds of nodes), so the
system is dense, as in the JAX package.

The JAX package takes the dense (E D, M D) Jacobian with `jax.jacfwd` over
all M D node directions. An edge's residual depends on its two nodes only,
so the port takes each edge's (D, 2 D) block by forward-mode
differentiation (`torch.func.jvp`) along its two nodes' 2 D directions, for
all edges at once, and places the blocks in the dense matrix: the same
Jacobian from 64 times fewer tangent evaluations at 128 nodes.

The JAX package's `while_loop` becomes a loop of at most `max_iters` passes
with a `done` mask (as in `ba.schur`): a finished state takes no further
update and `iterations` counts the live passes, so a solve repeats bit for
bit. Every `CHECK_EVERY` passes the host reads `done` and stops once it is
set, which changes no result. A pass is a few thousand small operations; on
a CUDA device it can be one replay of a captured graph (`captured`).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from ..lie import se3, sim3
from ..ops.graph import CapturedStep, tree_clone

CHECK_EVERY = 5


class PoseGraph(NamedTuple):
    T_wc: torch.Tensor      # (M, 4, 4) node poses (world <- camera)
    edge_i: torch.Tensor    # (E,) int
    edge_j: torch.Tensor    # (E,) int
    T_ij: torch.Tensor      # (E, 4, 4) measured relative transform (i <- j)
    weight: torch.Tensor    # (E,) information weight
    valid: torch.Tensor     # (E,) bool


class Sim3PoseGraph(NamedTuple):
    """Scale-drift-aware pose graph: Sim(3) nodes and measurements, so a loop
    edge can carry the relative monocular scale."""

    S_wc: torch.Tensor      # (M, 4, 4) Sim(3) node poses
    edge_i: torch.Tensor    # (E,) int
    edge_j: torch.Tensor    # (E,) int
    S_ij: torch.Tensor      # (E, 4, 4) measured relative Sim(3) (i <- j)
    weight: torch.Tensor    # (E,)
    valid: torch.Tensor     # (E,) bool


class PGOResult(NamedTuple):
    T_wc: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor   # live LM passes (int64 scalar)


def _residuals(group, T_wc, edge_i, edge_j, T_ij, weight, valid, deltas):
    """Weighted residuals (E, D) at the retracted poses T exp(delta)."""
    T = group.compose(T_wc, group.exp(deltas))
    return _edge_residuals(group, T[edge_i.long()], T[edge_j.long()], T_ij, weight, valid)


def _edge_residuals(group, Ti, Tj, T_ij, weight, valid):
    err = group.compose(group.inverse(T_ij), group.compose(group.inverse(Ti), Tj))
    w = torch.sqrt(torch.clamp(weight, min=0.0))
    return torch.where(valid[:, None], group.log(err) * w[:, None], 0.0)


def edge_residuals(graph: PoseGraph, deltas: torch.Tensor) -> torch.Tensor:
    """Residuals (E, 6) at retracted poses T_i exp(delta_i)."""
    return _residuals(se3, *graph, deltas)


def sim3_edge_residuals(graph: Sim3PoseGraph, deltas: torch.Tensor) -> torch.Tensor:
    """Residuals (E, 7) at retracted poses S_i exp(delta_i)."""
    return _residuals(sim3, *graph, deltas)


def _linearize(group, T, graph, D: int):
    """Residuals (E D,) and the dense Jacobian (E D, M D) at the poses T
    (delta = 0): each edge's (D, 2 D) block along its two nodes' directions,
    placed at its nodes' columns (summed where i == j)."""
    _, edge_i, edge_j, T_ij, weight, valid = graph
    M, E = T.shape[0], edge_i.shape[0]
    ei, ej = edge_i.long(), edge_j.long()
    Ti, Tj = T[ei], T[ej]

    def residual(d):        # (E, 2 D): delta_i, delta_j per edge
        return _edge_residuals(group, group.compose(Ti, group.exp(d[:, :D])),
                               group.compose(Tj, group.exp(d[:, D:])), T_ij, weight, valid)

    zero = torch.zeros((E, 2 * D), dtype=T.dtype, device=T.device)
    basis = torch.eye(2 * D, dtype=T.dtype, device=T.device)[:, None, :].expand(2 * D, E, 2 * D)
    r = residual(zero)
    cols = vmap(lambda t: jvp(residual, (zero,), (t,))[1])(basis)         # (2 D, E, D)
    blocks = cols.permute(1, 2, 0)                                        # (E, D, 2 D)
    nodes = torch.arange(M, device=T.device)
    oi = (ei[:, None] == nodes).to(T.dtype)[:, None, :, None]             # (E, 1, M, 1)
    oj = (ej[:, None] == nodes).to(T.dtype)[:, None, :, None]
    J = oi * blocks[:, :, None, :D] + oj * blocks[:, :, None, D:]         # (E, D, M, D)
    return r.reshape(-1), J.reshape(E * D, M * D)


def jacobian(graph, D: int) -> torch.Tensor:
    """The dense (E D, M D) Jacobian of the flattened residuals at delta = 0
    (D = 6: a PoseGraph, D = 7: a Sim3PoseGraph)."""
    return _linearize(se3 if D == 6 else sim3, graph[0], graph, D)[1]


def _lm_pass(group, D: int, normalize: bool, T, lam, cost, k, done, *rest):
    """One LM pass over the graph whose edge fields are `rest` (edge_i,
    edge_j, T_ij, weight, valid), from the state (T, lam, cost, k, done) ->
    the next state. A pass that is not live changes nothing."""
    M, dev, dt = T.shape[0], T.device, T.dtype
    graph = (T, *rest)
    # Gauge: node 0 frozen.
    mask = (torch.arange(M * D, device=dev) >= D).to(dt)
    active = ~done
    r, J = _linearize(group, T, graph, D)
    H = J.T @ J
    g = J.T @ r
    H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    g = g * mask
    Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * torch.eye(M * D, dtype=dt, device=dev)
    # solve_ex leaves `info` on the device.
    delta = -torch.linalg.solve_ex(Hd, g[:, None]).result[:, 0]
    T_new = group.compose(T, group.exp(delta.reshape(M, D)))
    if normalize:
        T_new = se3.normalize(T_new)
    new_cost = _cost(group, T_new, rest)
    accept = (new_cost < cost) & torch.isfinite(new_cost)
    take = active & accept
    lam_next = torch.clamp(torch.where(accept, lam * 0.3, lam * 6.0), 1e-9, 1e7)
    finished = (accept & (torch.linalg.vector_norm(delta) < 1e-7)) | (lam > 1e6)
    return (torch.where(take, T_new, T), torch.where(active, lam_next, lam),
            torch.where(take, new_cost, cost), k + active.long(),
            torch.where(active, finished, done))


def _cost(group, T, rest):
    edge_i, edge_j, *measured = rest
    r = _edge_residuals(group, T[edge_i.long()], T[edge_j.long()], *measured)
    return 0.5 * torch.sum(r * r)


def _optimize(group, graph, D: int, max_iters: int, init_lambda: float, normalize,
              captured: dict | None) -> PGOResult:
    T0, *rest = graph
    dev, dt = T0.device, T0.dtype
    c0 = _cost(group, T0, rest)
    state = (T0, torch.full((), init_lambda, dtype=dt, device=dev), c0,
             torch.zeros((), dtype=torch.long, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    step = partial(_lm_pass, group, D, normalize)
    graphed = captured is not None and dev.type == "cuda"
    if graphed:
        key = (D, *T0.shape, *rest[0].shape)
        if key not in captured:
            captured[key] = CapturedStep(step, (*state, *rest))
        step = captured[key]
    for p in range(max_iters):
        state = step(*state, *rest)
        if (p + 1) % CHECK_EVERY == 0 and bool(state[4]):
            break
    # A replay's outputs are the graph's own, which the next solve overwrites.
    T, _, cost, k, _ = tree_clone(state) if graphed else state
    return PGOResult(T_wc=T, cost=cost, initial_cost=c0, iterations=k)


def optimize_pose_graph(graph: PoseGraph, max_iters: int = 30, init_lambda: float = 1e-4,
                        captured: dict | None = None) -> PGOResult:
    """LM on the SE(3) pose graph; node 0 is the gauge anchor. On a CUDA
    device with a `captured` dict, one LM pass is a CUDA graph captured once
    per graph shape and kept there, and each pass a replay (a pass is a few
    thousand small operations)."""
    return _optimize(se3, graph, 6, max_iters, init_lambda, True, captured)


def optimize_pose_graph_sim3(graph: Sim3PoseGraph, max_iters: int = 30,
                             init_lambda: float = 1e-4,
                             captured: dict | None = None) -> PGOResult:
    """LM on the Sim(3) pose graph; node 0 fixes the gauge and the global
    scale. The result's `T_wc` holds the Sim(3) node poses. `captured` as in
    `optimize_pose_graph`."""
    return _optimize(sim3, graph, 7, max_iters, init_lambda, False, captured)


def odometry_edges(T_wc: torch.Tensor, weight: float = 1.0) -> PoseGraph:
    """A chain pose graph from consecutive trajectory poses."""
    M, dev = T_wc.shape[0], T_wc.device
    i = torch.arange(M - 1, dtype=torch.int32, device=dev)
    j = i + 1
    T_ij = se3.compose(se3.inverse(T_wc[i.long()]), T_wc[j.long()])
    return PoseGraph(
        T_wc=T_wc, edge_i=i, edge_j=j, T_ij=T_ij,
        weight=torch.full((M - 1,), weight, dtype=T_wc.dtype, device=dev),
        valid=torch.ones(M - 1, dtype=torch.bool, device=dev),
    )


def add_loop_edge(graph: PoseGraph, i: int, j: int, T_ij: torch.Tensor,
                  weight: float = 1.0) -> PoseGraph:
    """Append one loop-closure constraint."""
    dev = graph.T_wc.device
    return PoseGraph(
        T_wc=graph.T_wc,
        edge_i=torch.cat([graph.edge_i, torch.tensor([i], dtype=graph.edge_i.dtype, device=dev)]),
        edge_j=torch.cat([graph.edge_j, torch.tensor([j], dtype=graph.edge_j.dtype, device=dev)]),
        T_ij=torch.cat([graph.T_ij, T_ij[None].to(graph.T_ij.dtype)]),
        weight=torch.cat([graph.weight, torch.tensor([weight], dtype=graph.weight.dtype,
                                                     device=dev)]),
        valid=torch.cat([graph.valid, torch.ones(1, dtype=torch.bool, device=dev)]),
    )
