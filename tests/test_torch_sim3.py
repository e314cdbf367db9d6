"""Parity of the port's Sim(3) (`uwslam_tpu_torch.lie.sim3`) with the JAX
package's, on twists made with numpy from a seed: small and large angles,
theta near 0, sigma near 0 and both at once (the Taylor branches of
`_calc_W`).

Tolerances: f32 closed forms of O(1) values agree to 2e-5 absolute
(`exp`, `inverse`, `compose`, `apply`, `scale`); `log` goes through a 3x3
solve and an arccos-free rotation log, 1e-4. The round trip exp(log(T))
holds to 1e-5, and forward-mode Jacobians through exp and log are finite at
both limits (tests/test_lie.py:205 asks the same of JAX) and equal JAX's to
1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.lie import sim3 as jsim3  # noqa: E402
from uwslam_tpu_torch.lie import sim3  # noqa: E402


def _twists(kind: str, n: int = 48, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 7))
    if kind == "small":
        xi *= 0.05
    elif kind == "large":
        xi[:, 3:6] *= 1.2
        xi[:, 6] *= 0.5
    elif kind == "theta0":
        xi[:, 3:6] *= 1e-8
        xi[:, 6] *= 0.3
    elif kind == "sigma0":
        xi[:, 6] *= 1e-8
    elif kind == "both0":
        xi[:, 3:] *= 1e-8
    return xi.astype(np.float32)


KINDS = ["small", "large", "theta0", "sigma0", "both0"]


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_exp_matches_jax(kind):
    xi = _twists(kind)
    np.testing.assert_allclose(sim3.exp(_t(xi)).numpy(), np.asarray(jsim3.exp(jnp.asarray(xi))),
                               atol=2e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_calc_w_matches_jax(kind):
    xi = _twists(kind)
    np.testing.assert_allclose(
        sim3._calc_W(_t(xi[:, 3:6]), _t(xi[:, 6])).numpy(),
        np.asarray(jsim3._calc_W(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6]))), atol=2e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_log_matches_jax_and_round_trips(kind):
    T = np.asarray(jsim3.exp(jnp.asarray(_twists(kind, seed=1))))
    got = sim3.log(_t(T)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsim3.log(jnp.asarray(T))), atol=1e-4)
    np.testing.assert_allclose(sim3.exp(_t(got)).numpy(), T, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_group_operations_match_jax(kind):
    Ta = np.asarray(jsim3.exp(jnp.asarray(_twists(kind, seed=2))))
    Tb = np.asarray(jsim3.exp(jnp.asarray(_twists(kind, seed=3))))
    p = np.random.default_rng(4).normal(size=(Ta.shape[0], 3)).astype(np.float32)
    checks = [
        (sim3.inverse(_t(Ta)), jsim3.inverse(jnp.asarray(Ta))),
        (sim3.compose(_t(Ta), _t(Tb)), jsim3.compose(jnp.asarray(Ta), jnp.asarray(Tb))),
        (sim3.apply(_t(Ta), _t(p)), jsim3.apply(jnp.asarray(Ta), jnp.asarray(p))),
        (sim3.scale(_t(Ta)), jsim3.scale(jnp.asarray(Ta))),
        (sim3.rotation(_t(Ta)), jsim3.rotation(jnp.asarray(Ta))),
        (sim3.translation(_t(Ta)), jsim3.translation(jnp.asarray(Ta))),
    ]
    for got, want in checks:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_from_rst_and_identity_match_jax():
    xi = _twists("large", n=8, seed=5)
    T = np.asarray(jsim3.exp(jnp.asarray(xi)))
    R = np.asarray(jsim3.rotation(jnp.asarray(T)))
    s = np.exp(xi[:, 6])
    t = T[:, :3, 3]
    np.testing.assert_allclose(
        sim3.from_rst(_t(R), _t(s), _t(t)).numpy(),
        np.asarray(jsim3.from_rst(jnp.asarray(R), jnp.asarray(s), jnp.asarray(t))), atol=1e-6)
    np.testing.assert_array_equal(sim3.identity().numpy(), np.asarray(jsim3.identity()))


ANCHORS = [
    np.zeros(7, np.float32),
    np.asarray([0.5, 0, 0, 0, 0, 0, 0.08], np.float32),   # theta = 0, sigma != 0
    np.asarray([0.5, 0, 0, 0.2, 0, 0, 0.0], np.float32),  # theta != 0, sigma = 0
    np.asarray([0.1, 0.05, -0.02, 0.01, 0.02, -0.03, 0.04], np.float32),
]


@pytest.mark.parametrize("x0", ANCHORS, ids=["identity", "theta0", "sigma0", "generic"])
def test_jacfwd_through_exp_log_is_finite_and_matches_jax(x0):
    # A batch of one twist, as the pose graph differentiates: under
    # torch.func.jacfwd a 0-dim tensor in arithmetic with a Python float
    # takes a float64 tangent.
    def port(d):
        return sim3.log(sim3.compose(sim3.exp(_t(x0[None])), sim3.exp(d[None])))[0]

    J = torch.func.jacfwd(port)(torch.zeros(7))
    assert J.dtype == torch.float32
    assert torch.isfinite(J).all()
    Jj = jax.jacfwd(lambda d: jsim3.log(jsim3.compose(jsim3.exp(jnp.asarray(x0)),
                                                      jsim3.exp(d))))(jnp.zeros(7))
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-3)
