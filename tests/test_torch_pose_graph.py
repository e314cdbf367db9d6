"""Parity of the port's pose-graph optimization (`uwslam_tpu_torch.ba.
pose_graph`) with the JAX package's, on the cases of tests/test_pose_graph.py:
one numpy graph through both packages.

Tolerances: the Jacobian (taken by `torch.func.jacfwd` in the port, by
`jax.jacfwd` in the JAX package) agrees to 1e-4 absolute on O(1)-O(10)
entries; poses agree to 1e-4 and costs to 1e-3 relative or 1e-9 of the
initial cost (f32 LM, an LU solve of a 72-96 unknown system in another
order). LM iterations are equal pass for pass while the cost descends (the
first three). Where a solve ends is not a property of the algorithm: once
the cost sits at f32's noise floor (1e-14 here), each pass's accept test
compares rounding noise, and the JAX package's own count moves with the
host's instruction set (drift case 16 / 13 / 26 / 26, gauge case 15 / 15 /
13 / 13, Sim(3) case 23 / 23 / 24 / 24 under XLA's default, AVX2, AVX and
SSE4_2 code). The full solves are held to the same poses and to both
stopping before `max_iters` (the termination rule fired). In float64 both
packages follow each other pass for pass and stop on costs within 64 ulp
(see `test_float64_solves_follow_jax_pass_for_pass`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.ba import pose_graph as jpg  # noqa: E402
from uwslam_tpu.lie import se3 as jse3, sim3 as jsim3  # noqa: E402
from uwslam_tpu_torch.ba import pose_graph as pg  # noqa: E402
from uwslam_tpu_torch.interop import pose_graph_from_numpy  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402


def circle_trajectory(n=12, radius=1.0):
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        xi = jnp.asarray([radius * np.cos(a), radius * np.sin(a), 0.0, 0.0, 0.0, a], jnp.float32)
        poses.append(jse3.exp(xi))
    return jnp.stack(poses)


def _drift_graph():
    """tests/test_pose_graph.py:test_loop_closure_corrects_drift's graph."""
    T_gt = circle_trajectory()
    n = T_gt.shape[0]
    noise = (0.05 * jax.random.normal(jax.random.PRNGKey(0), (n, 6))).at[0].set(0.0)
    T_drift = jax.vmap(lambda T, d: jse3.compose(T, jse3.exp(d)))(T_gt, noise)
    g = jpg.odometry_edges(T_gt)._replace(T_wc=T_drift)
    T_loop = jse3.compose(jse3.inverse(T_gt[n - 1]), T_gt[0])
    return jpg.add_loop_edge(g, n - 1, 0, T_loop, weight=2.0), T_gt


def _gauge_graph():
    T_gt = circle_trajectory(8)
    noise = (0.03 * jax.random.normal(jax.random.PRNGKey(1), (8, 6))).at[0].set(0.0)
    T_n = jax.vmap(lambda T, d: jse3.compose(T, jse3.exp(d)))(T_gt, noise)
    return jpg.odometry_edges(T_gt)._replace(T_wc=T_n)


def _sim3_graph():
    """tests/test_pose_graph.py:TestSim3PoseGraph's scale-drift graph."""
    n = 8
    gt = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.5 * i if i < n // 2 else 0.5 * (n - 1 - i)
        gt.append(T)
    S = [jnp.asarray(gt[0])]
    ei, ej, Sij, w = [], [], [], []
    for k in range(n - 1):
        rel = np.linalg.inv(gt[k]) @ gt[k + 1]
        drift = 1.08 ** (k + 1)
        rel_d = jsim3.from_rst(jnp.asarray(rel[:3, :3]), jnp.asarray(drift),
                               jnp.asarray(rel[:3, 3] * drift))
        S.append(jsim3.compose(S[-1], rel_d))
        ei.append(k), ej.append(k + 1), Sij.append(np.asarray(rel_d)), w.append(10.0)
    ei.append(0), ej.append(n - 1), Sij.append((np.linalg.inv(gt[0]) @ gt[-1]).astype(np.float32))
    w.append(100.0)
    return jpg.Sim3PoseGraph(
        S_wc=jnp.stack(S), edge_i=jnp.asarray(ei, jnp.int32), edge_j=jnp.asarray(ej, jnp.int32),
        S_ij=jnp.asarray(np.stack(Sij)), weight=jnp.asarray(w, jnp.float32),
        valid=jnp.ones(len(ei), bool),
    ), gt


def _port(graph, sim3=False):
    return pose_graph_from_numpy(graph, device="cpu", sim3=sim3)


def test_zero_residual_consistent_graph():
    g = jpg.odometry_edges(circle_trajectory())
    r = pg.edge_residuals(_port(g), torch.zeros(12, 6))
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(
        r.numpy(), np.asarray(jax.jit(jpg.edge_residuals)(g, jnp.zeros((12, 6)))), atol=1e-5)


def _jax_jacobian(graph, D):
    M = graph[0].shape[0]
    res = jpg.edge_residuals if D == 6 else jpg.sim3_edge_residuals

    def residual_flat(d):
        return res(graph, d.reshape(M, D)).reshape(-1)

    return np.asarray(jax.jit(jax.jacfwd(residual_flat))(jnp.zeros(M * D)))


@pytest.mark.parametrize("case", ["se3-drift", "se3-gauge", "sim3"])
def test_jacobian_matches_jax(case):
    if case == "sim3":
        graph, D = _sim3_graph()[0], 7
    else:
        graph, D = (_drift_graph()[0] if case == "se3-drift" else _gauge_graph()), 6
    J = pg.jacobian(_port(graph, sim3=D == 7), D)
    Jj = _jax_jacobian(graph, D)
    assert J.shape == Jj.shape and J.dtype == torch.float32
    np.testing.assert_allclose(J.numpy(), Jj, atol=1e-4)


def _assert_same_solve(out, want, max_iters):
    np.testing.assert_allclose(out.T_wc.numpy(), np.asarray(want.T_wc), atol=1e-4)
    c0 = float(want.initial_cost)
    np.testing.assert_allclose(float(out.initial_cost), c0, rtol=1e-5)
    np.testing.assert_allclose(float(out.cost), float(want.cost), rtol=1e-3, atol=1e-9 * c0)
    assert int(out.iterations) < max_iters and int(want.iterations) < max_iters


CASES = {
    "se3-drift": lambda: (_drift_graph()[0], False),
    "se3-gauge": lambda: (_gauge_graph(), False),
    "sim3": lambda: (_sim3_graph()[0], True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_descent_matches_jax_pass_for_pass(case):
    graph, is_sim3 = CASES[case]()
    port = pg.optimize_pose_graph_sim3 if is_sim3 else pg.optimize_pose_graph
    ref = jpg.optimize_pose_graph_sim3 if is_sim3 else jpg.optimize_pose_graph
    out, want = port(_port(graph, is_sim3), max_iters=3), ref(graph, max_iters=3)
    assert int(out.iterations) == int(want.iterations) == 3
    np.testing.assert_allclose(out.T_wc.numpy(), np.asarray(want.T_wc), atol=1e-4)
    np.testing.assert_allclose(float(out.cost), float(want.cost), rtol=1e-3,
                               atol=1e-9 * float(want.initial_cost))


def test_loop_closure_corrects_drift_like_jax():
    graph, T_gt = _drift_graph()
    out = pg.optimize_pose_graph(_port(graph), max_iters=40)
    _assert_same_solve(out, jpg.optimize_pose_graph(graph, max_iters=40), 40)
    assert float(out.cost) < float(out.initial_cost) * 1e-3
    T_gt = torch.from_numpy(np.asarray(T_gt))
    err = se3.log(se3.compose(se3.inverse(T_gt), out.T_wc))
    assert torch.linalg.vector_norm(err, dim=-1).max() < 1e-2


def test_gauge_anchor_fixed_like_jax():
    graph = _gauge_graph()
    out = pg.optimize_pose_graph(_port(graph), max_iters=30)
    _assert_same_solve(out, jpg.optimize_pose_graph(graph, max_iters=30), 30)
    np.testing.assert_allclose(out.T_wc[0].numpy(), np.asarray(graph.T_wc[0]), atol=1e-5)


def test_sim3_scale_drift_corrected_like_jax():
    graph, gt = _sim3_graph()
    out = pg.optimize_pose_graph_sim3(_port(graph, sim3=True), max_iters=40)
    _assert_same_solve(out, jpg.optimize_pose_graph_sim3(graph, max_iters=40), 40)
    assert float(out.cost) < 0.1 * float(out.initial_cost)
    from uwslam_tpu_torch.lie import sim3

    assert np.linalg.norm(out.T_wc[-1, :3, 3].numpy() - gt[-1][:3, 3]) < 0.2
    drift0 = float(jsim3.scale(graph.S_wc[-1]))
    assert abs(float(sim3.scale(out.T_wc[-1])) - 1.0) < 0.5 * abs(drift0 - 1.0)


def test_solve_repeats_bit_for_bit():
    graph = _port(_drift_graph()[0])
    a = pg.optimize_pose_graph(graph, max_iters=40)
    b = pg.optimize_pose_graph(graph, max_iters=40)
    assert torch.equal(a.T_wc, b.T_wc) and torch.equal(a.cost, b.cost)


def test_add_loop_edge_and_odometry_edges_match_jax():
    T = circle_trajectory(6)
    g = jpg.add_loop_edge(jpg.odometry_edges(T, weight=3.0), 5, 0,
                          jse3.compose(jse3.inverse(T[5]), T[0]), weight=2.0)
    p = pg.add_loop_edge(pg.odometry_edges(torch.from_numpy(np.asarray(T)), weight=3.0), 5, 0,
                         se3.compose(se3.inverse(torch.from_numpy(np.asarray(T[5]))),
                                     torch.from_numpy(np.asarray(T[0]))), weight=2.0)
    for a, b in zip(p, g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


F64_PASSES = {"se3-drift": 4, "se3-gauge": 4, "sim3": 6}   # passes that change the cost
F64_ULP = np.finfo(np.float64).eps


def _float64_solves(case, max_iters):
    """Both solvers in float64 on the f32 graph's values (the JAX package
    under `jax.enable_x64`) -> (port result, JAX's (T_wc, cost, iterations))."""
    graph, is_sim3 = CASES[case]()
    port = pg.optimize_pose_graph_sim3 if is_sim3 else pg.optimize_pose_graph
    ref = jpg.optimize_pose_graph_sim3 if is_sim3 else jpg.optimize_pose_graph
    host = [np.asarray(x) for x in graph]
    with jax.enable_x64(True):
        g64 = type(graph)(*[jnp.asarray(x, jnp.float64 if x.dtype == np.float32 else x.dtype)
                            for x in host])
        want = ref(g64, max_iters=max_iters)
        assert want.T_wc.dtype == jnp.float64
        want = [np.asarray(x) for x in (want.T_wc, want.cost, want.iterations)]
    p = _port(graph, is_sim3)
    out = port(type(p)(*[x.double() if x.dtype == torch.float32 else x for x in p]),
               max_iters=max_iters)
    assert out.T_wc.dtype == torch.float64
    return out, want


@pytest.mark.parametrize("case", list(CASES))
def test_float64_solves_follow_jax_pass_for_pass(case):
    """In float64 the solves agree pass for pass while the cost falls (poses
    within 1e-10, costs within 64 ulp of the initial cost; the final poses
    measured 2e-16 to 7e-16 apart), and both stop by their own rule. The SE(3) cases
    stop after the same number of passes (4 and 4 under XLA's default,
    AVX2, AVX and SSE4_2 code). The Sim(3) case ends on a cost of 3.32, and
    its last accept test compares candidates 2 ulp apart: the JAX package's
    own count is 7 under the default code and 12 under AVX2 (passes 7-11
    rejected), the port's 7. So the f32 counts of ROADMAP section 3's fault 4
    part by rounding, not by an accept or stop rule."""
    for k in range(1, F64_PASSES[case] + 1):
        out, want = _float64_solves(case, k)
        assert int(out.iterations) == int(want[2]) == k
        np.testing.assert_allclose(out.T_wc.numpy(), want[0], atol=1e-10)
        np.testing.assert_allclose(float(out.cost), float(want[1]), rtol=0,
                                   atol=64 * F64_ULP * float(out.initial_cost))
    out, want = _float64_solves(case, 40)
    assert int(out.iterations) < 40 and int(want[2]) < 40
    np.testing.assert_allclose(float(out.cost), float(want[1]), rtol=0,
                               atol=64 * F64_ULP * float(out.initial_cost))
    np.testing.assert_allclose(out.T_wc.numpy(), want[0], atol=1e-10)
    if case != "sim3":
        assert int(out.iterations) == int(want[2])
