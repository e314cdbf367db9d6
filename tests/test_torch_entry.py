"""The port's entry points (`uwslam_tpu_torch.entry`) against the
repository's `__graft_entry__.py` (the JAX package's).

- `entry(device="cpu")`: the tracking step's pose against the JAX
  package's jitted step on its own pair, within 1e-4 on se3.log (the
  tolerance of the IC tracking parity test, tests/test_torch_track.py:
  f32 sums in another order); the two synthetic pairs within 1e-3 gray
  levels (tests/test_torch_photometric_ba.py's render bound).
- `dryrun_multichip(8, device="cpu")` runs its three steps to finite
  outputs; the default device is the card, which this host lacks.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from uwslam_tpu_torch import entry as port_entry  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def graft():
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as ge

    return ge


def test_entry_matches_the_jax_entry(graft):
    fn_j, args_j = graft.entry()
    T_j = np.array(jax.jit(fn_j)(*args_j))
    fn, args = port_entry.entry(device="cpu")
    for a, b in zip(args, args_j):
        assert a.shape == (480, 640)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    T = fn(*args)
    assert T.shape == (4, 4) and bool(torch.isfinite(T).all())
    gap = (se3.log(T) - se3.log(torch.from_numpy(T_j))).abs().max()
    assert float(gap) < 1e-4
    # The true motion of the target view (tracked to the JAX package's accuracy).
    want = se3.exp(torch.tensor([0.02, -0.01, 0.005, 0.004, -0.003, 0.008]))
    assert float((se3.log(T) - se3.log(want)).abs().max()) < 1e-3


def test_dryrun_multichip_runs_on_the_cpu():
    out = port_entry.dryrun_multichip(8, device="cpu")
    assert out["track"].shape == (9, 4, 4)
    assert int(out["ba"].iterations) >= 1 and bool(torch.isfinite(out["ba"].T_cw).all())
    assert out["photo_ba"].T_cw.shape == (8, 4, 4)
    assert float(out["photo_ba"].cost) <= float(out["photo_ba"].initial_cost)


def test_the_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA card"):
        port_entry.dryrun_multichip(2)
