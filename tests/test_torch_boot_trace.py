"""The tracer's span and counters of the depth bootstrap (eval.py config 2)
in the port's pipelined loop, on the CPU at test size, where the bootstrap
megastep runs eagerly: the span `ransac_uniforms` times the host's draw of
every frame's uniforms; `boot_replays` counts the frames dispatched through
the bootstrap megastep, `boot_inits` the prior's installs and `boot_resets`
its drops after a loss; `boot_matches` and `boot_inliers` sum the two
counts that the megastep adds to its diagnostics row, over the frames
retired as tracked (a frame found lost is not counted); the plain
megastep's row keeps its 26 floats. This file imports
neither JAX nor the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from uwslam_tpu_torch.camera import Calibration, PinholeCamera  # noqa: E402
from uwslam_tpu_torch.config import SlamConfig, TrackerConfig  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402
from uwslam_tpu_torch.system import BOOT_DIAG, PIPE_DIAG, SlamSystem  # noqa: E402
from uwslam_tpu_torch.utils.synthetic import render_scene_view  # noqa: E402

CAM = PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
TRACKER = dict(pyramid_levels=4, track_levels=(2, 1, 0), num_points=512, point_block=4,
               mono_depth=2.5)
BOOT = dict(TRACKER, depth_bootstrap=True, bootstrap_anchor_frames=4, affine_brightness=True)


def scene_frames(n=14):
    """The default multi-plane scene along a parallax-rich path; the first
    pair three steps apart, so that the two-view bootstrap has a baseline."""
    out = []
    for j in range(n):
        i = j + 2 if j else 0
        xi = torch.tensor([0.04 * i, 0.015 * i, 0.01 * i, 0.003 * i, 0.01 * i, 0.004 * i])
        out.append(render_scene_view(CAM, se3.exp(xi)))
    return out


def make_system(boot: bool) -> SlamSystem:
    config = (SlamConfig(tracker=TrackerConfig(**BOOT), use_features=True) if boot
              else SlamConfig(tracker=TrackerConfig(**TRACKER)))
    return SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120), config, device="cpu")


def run(system, frames):
    """The pipelined loop over `frames` and a flush -> (the records its
    megastep dispatched, whether each call could pipeline)."""
    records, entered = [], []
    dispatch = system._dispatch_pipelined

    def kept(image, ts):
        rec = dispatch(image, ts)
        records.append(rec)
        return rec

    system._dispatch_pipelined = kept
    for i, f in enumerate(frames):
        entered.append(system._can_pipeline(None))
        system.process_frame_async(f, timestamp=float(i))
    system.flush()
    return records, entered


@pytest.fixture(scope="module")
def boot_run():
    system = make_system(boot=True)
    return (system, *run(system, scene_frames()))


def test_ransac_uniforms_are_timed_per_draw(boot_run):
    system, records, _ = boot_run
    counts = system.tracer.counts
    assert counts["boot_replays"] > 0
    # one draw per dispatched frame and one per synchronous match
    assert system.tracer.calls["ransac_uniforms"] >= counts["boot_replays"]
    assert system.retire_host_s["ransac_uniforms"] > 0.0
    assert system.tracer.parents["ransac_uniforms"] >= {"dispatch"}
    assert all(r["uniforms"].shape == (256, 768) for r in records)


def test_boot_replays_count_the_frames_of_the_megastep(boot_run):
    system, records, entered = boot_run
    counts = system.tracer.counts
    assert counts["boot_replays"] == counts["dispatched"] == len(records) == sum(entered)
    assert counts["boot_replays"] == sum(1 for s in system.trajectory if s.in_flight is not None)
    assert counts["boot_inits"] == 1 and counts["boot_resets"] == 0


def tracked_rows(system, records):
    """The diagnostics rows of the dispatched frames that retired tracked."""
    status = {s.frame_id: s.status for s in system.trajectory}
    return np.stack([r["diag"].numpy() for r in records if status[r["frame_id"]] == "ok"])


def test_match_and_inlier_counters_sum_the_rows(boot_run):
    system, records, _ = boot_run
    rows = tracked_rows(system, records)
    assert rows.shape == (len(records), BOOT_DIAG)
    matches, inliers = rows[:, PIPE_DIAG], rows[:, PIPE_DIAG + 1]
    counts = system.tracer.counts
    assert counts["boot_matches"] == int(matches.sum()) > 0
    assert counts["boot_inliers"] == int(inliers.sum()) > 0
    assert (inliers <= matches).all()
    line = system.tracer.line()
    assert (f"boot: {counts['boot_replays']} replays, 1 prior installs, 0 drops, "
            f"{counts['boot_matches']} matches, {counts['boot_inliers']} inliers") in line


def test_the_plain_row_is_unchanged():
    system = make_system(boot=False)
    frames = scene_frames(6)
    records, _ = run(system, frames)
    assert records and all(r["diag"].shape == (PIPE_DIAG,) for r in records)
    assert all(r["uniforms"] is None and r["feats"] is None for r in records)
    by_id = {s.frame_id: s for s in system.trajectory}
    for r in records:
        np.testing.assert_array_equal(r["diag"][4:20].numpy().reshape(4, 4),
                                      by_id[r["frame_id"]].T_wc)
    counts = system.tracer.counts
    assert not any(counts[k] for k in ("boot_replays", "boot_inits", "boot_matches"))
    assert "boot:" not in system.tracer.line()


def test_a_loss_counts_one_drop_of_the_prior():
    system = make_system(boot=True)
    frames = scene_frames(8)
    for i, f in enumerate(frames):
        system.process_frame(f, timestamp=float(i))
    assert system._depth_prior is not None and system.tracer.counts["boot_inits"] == 1
    noise = np.random.default_rng(0).uniform(0, 255, (120, 160)).astype(np.float32)
    state = system.process_frame(noise, timestamp=8.0)
    assert state.status in ("lost", "relocalized")
    assert system._depth_prior is None
    assert system.tracer.counts["boot_resets"] == 1


def test_a_frame_found_lost_is_not_counted():
    """A pipelined frame that retirement finds lost (here frame 8, which
    matched well) keeps its row's counts out of `boot_matches` and
    `boot_inliers`, and the prior it breaks is dropped once."""
    system = make_system(boot=True)
    retiring = {"id": None}
    retire, is_lost = system._retire_frame, system._is_lost

    def retire_marked(rec, row):
        retiring["id"] = rec["frame_id"]
        try:
            return retire(rec, row)
        finally:
            retiring["id"] = None

    system._retire_frame = retire_marked
    system._is_lost = lambda *a: retiring["id"] == 8 or is_lost(*a)
    records, _ = run(system, scene_frames(12))
    status = {s.frame_id: s.status for s in system.trajectory}
    assert status[8] != "ok"
    lost_row = next(r["diag"].numpy() for r in records if r["frame_id"] == 8)
    assert lost_row[PIPE_DIAG] > 0 and lost_row[PIPE_DIAG + 1] > 0
    rows = tracked_rows(system, records)
    counts = system.tracer.counts
    assert counts["boot_matches"] == int(rows[:, PIPE_DIAG].sum())
    assert counts["boot_inliers"] == int(rows[:, PIPE_DIAG + 1].sum())
    assert counts["boot_resets"] == 1
