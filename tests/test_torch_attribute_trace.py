"""The port's device-time attribution (`python -m uwslam_tpu_torch.attribute_trace`)
on the CPU, where it attributes CPU operator time (each operator's self time
under `torch.profiler`), labelled so: the chunk at 160 x 120 (the bench
camera scaled by 4, 4 pyramid levels, 256 points), 4 frames, one chunk.

- The rows, the rows under the threshold and `<unattributed>` sum to the
  profiler's own total of operator time within 1%; on a synthetic trace each
  kernel follows its launch to the wrapper, and each operator counts its
  self time.
- Every row's source is `uwslam_tpu_torch/...py:N` or `<unattributed>`, and
  the chunk's own modules appear.
- On a card (`cuda` marker; skips here): the four hand-written kernels under
  their wrappers' files with 5 / 5 / 3 / 32 launches per chunk, at most 2% of
  the kernel time unattributed.
"""
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from uwslam_tpu_torch import attribute_trace, bench, offline_budget  # noqa: E402

CAM = bench.CAM.scaled(2)
DESIGN = offline_budget.Design(levels=4, num_points=256)
SOURCE = re.compile(r"^uwslam_tpu_torch/[\w/]+\.py:\d+$")


@pytest.fixture(scope="module")
def cpu_attribution():
    _, frames = offline_budget.scene(4, CAM, device="cpu")
    return attribute_trace.attribute(frames, CAM, DESIGN, chunks=1)


def test_rows_sum_to_the_profilers_total(cpu_attribution):
    a = cpu_attribution
    assert a["measured"].startswith("CPU operator self time")
    assert a["device_busy_ms_per_chunk"] is None and a["device_span_ms_per_chunk"] is None
    rows = sum(r["ms_per_chunk"] for r in a["attribution"])
    summed = rows + a["below_row_ms_per_chunk"] + a["unattributed_ms_per_chunk"]
    assert summed == pytest.approx(a["rows_ms_per_chunk"], rel=1e-9)
    assert summed == pytest.approx(a["total_ms_per_chunk"], rel=1e-2)
    assert all(r["ms_per_chunk"] >= attribute_trace.MIN_ROW_MS for r in a["attribution"])


def test_every_source_is_a_package_line(cpu_attribution):
    rows = cpu_attribution["attribution"]
    assert rows and all(SOURCE.match(r["source"]) for r in rows)
    files = {r["source"].split(":")[0] for r in rows}
    assert {"uwslam_tpu_torch/ops/cuda_pyramid.py", "uwslam_tpu_torch/utils/linalg.py",
            "uwslam_tpu_torch/tracking/photometric.py"} <= files
    assert all(not f.endswith("ops/_lib.py") for f in files)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def test_kernels_follow_their_launch_to_the_wrapper():
    """A synthetic card trace: a hand-written kernel launched inside the
    launcher's range under its wrapper, an aten kernel under a package
    function but a foreign one nearer, a kernel whose launch has no
    operator, and the range's device-side copy (no kernel)."""
    events = [
        _x("python_function", "uwslam_tpu_torch/image/pyramid.py(50): build", 0, 100),
        _x("python_function", "/abs/uwslam_tpu_torch/ops/cuda_pyramid.py(23): scharr", 10, 40),
        _x("python_function", "uwslam_tpu_torch/ops/_lib.py(150): launch", 12, 30),
        _x("user_annotation", "uws_scharr", 14, 20, **{"External id": 7}),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 5, correlation=70),    # ctypes: no op
        _x("kernel", "void (anonymous namespace)::scharr_kernel(float const*, int)", 200, 3.0,
           tid=7, correlation=70),
        _x("gpu_user_annotation", "uws_scharr", 200, 3.0, tid=7),
        _x("python_function", "torch/nn/functional.py(10): pad", 60, 20),
        _x("cpu_op", "aten::constant_pad_nd", 62, 10, **{"External id": 8}),
        _x("cuda_runtime", "cudaLaunchKernel", 63, 2, correlation=80, **{"External id": 8}),
        _x("kernel", "void at::native::pad_kernel<float>(int)", 205, 2.0, tid=7, correlation=80),
        _x("cuda_runtime", "cudaMemcpyAsync", 90, 2, correlation=90, tid=2),
        _x("gpu_memcpy", "Memcpy HtoD", 210, 1.0, tid=7, correlation=90),
    ]
    got = attribute_trace.attribute_events(events, cuda=True)
    assert dict(got["rows"]) == {
        ("uwslam_tpu_torch/ops/cuda_pyramid.py:23", "scharr_kernel"): [0.003, 1],
        ("uwslam_tpu_torch/image/pyramid.py:50", "aten::constant_pad_nd"): [0.002, 1],
        (attribute_trace.UNATTRIBUTED, "<no operator>"): [0.001, 1]}
    assert got["total_ms"] == pytest.approx(0.006)
    assert got["span_ms"] == pytest.approx(0.011)


def test_cpu_operators_count_their_self_time():
    events = [
        _x("python_function", "uwslam_tpu_torch/lie/se3.py(17): exp", 0, 50),
        _x("cpu_op", "aten::mul", 5, 30),
        _x("cpu_op", "aten::empty", 10, 4),
        _x("cpu_op", "aten::add", 40, 5),
        _x("cpu_op", "aten::sub", 60, 5),
    ]
    rows = dict(attribute_trace.attribute_events(events, cuda=False)["rows"])
    assert rows == {("uwslam_tpu_torch/lie/se3.py:17", "aten::mul"): [0.026, 1],
                    ("uwslam_tpu_torch/lie/se3.py:17", "aten::empty"): [0.004, 1],
                    ("uwslam_tpu_torch/lie/se3.py:17", "aten::add"): [0.005, 1],
                    (attribute_trace.UNATTRIBUTED, "aten::sub"): [0.005, 1]}
    assert attribute_trace.kernel_name(
        "void (anonymous namespace)::bilinear_sample_kernel<true>(float const*, int)") == \
        "bilinear_sample_kernel<true>"


@pytest.mark.cuda
def test_hand_written_kernels_land_on_their_wrappers():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, frames = offline_budget.scene(bench.NUM_FRAMES, device=torch.device("cuda", 0))
    a = attribute_trace.attribute(frames, bench.CAM, chunks=1)
    assert a["unattributed_ms_per_chunk"] <= 0.02 * a["device_busy_ms_per_chunk"]
    want = {("pyramid_kernel", "ops/cuda_pyramid.py"): 1, ("warp_sample_kernel", "ops/cuda_track.py"): 5,
            ("bilinear_sample_kernel", "ops/cuda_sample.py"): 3,
            ("lm_evaluate_kernel", "ops/cuda_track.py"): 32, ("lm_step_kernel", "ops/cuda_lm.py"): 32}
    for (kernel, wrapper), launches in want.items():
        rows = [r for r in a["hand_written"] if kernel in r["op"] and r["source"].split(":")[0]
                .endswith(wrapper)]
        assert sum(r["launches"] for r in rows) == launches, kernel
