"""The offline chunk's device time attributed to the port's source lines.

    python -m uwslam_tpu_torch.attribute_trace [--out ATTR_TORCH_r10.json] [--platform cuda|cpu]

Counterpart of `benchmarks/attribute_trace.py` (the JAX package's, which maps
HLO metadata to each device op). The port has no HLO: the bench chunk
(`offline_budget.full_chunk` on the bench's 96 frames) runs under
`torch.profiler` with Python stacks (`with_stack=True`), once per chunk for
`CHUNKS` chunks on the frames + 0.1 i (built before any profile, after one
warm-up chunk; on a card each profile opens on the same chunk once more,
traced and dropped, `micro.warm_profile`), and each profile's Chrome trace
is read. Each kernel (memory
copies and sets included) is followed through its correlation id to the
runtime call that launched it, and through that call's external id (or,
for a call that carries none, its place in time on its thread) to the
operator that enclosed the launch: an aten operator, or for the
hand-written kernels the `record_function` range that `ops._lib.launch`
opens inside `ops._lib.launch_ranges()` (a ctypes call is no operator; the
range's device-side copy, which spans its kernel, is no kernel and is left
out). The row's `source` is the innermost Python call event enclosing that
operator whose file lies in `uwslam_tpu_torch/` (the launcher `ops/_lib.py`
passed over, so a hand-written kernel lands on its wrapper), written
`uwslam_tpu_torch/file.py:N`: the profiler records a Python call where its
function starts, so N is the line of the enclosing function's `def`. The
row's `op` is the aten operator, or the hand-written kernel's name. A
kernel with no operator, or none of whose enclosing frames lies in the
package, is `<unattributed>`.

The output keeps the JAX script's keys (`device`, `chunk`,
`device_span_ms_per_chunk`: first kernel start to last kernel end, the mean
over the chunks; `attribution`: rows of at least `MIN_ROW_MS` ms per chunk,
each with `source`, `op`, `ms_per_chunk`) and adds `launches` per row,
`device_busy_ms_per_chunk` (the profiler's total kernel time),
`unattributed_ms_per_chunk`, `below_row_ms_per_chunk` (the rows under
`MIN_ROW_MS`), `hand_written` (the rows of the port's own kernels, whatever
their time) and the card's name and power limit. Rows, the rows below the
threshold and `unattributed` sum to `rows_ms_per_chunk`, the trace's total,
which `total_ms_per_chunk` (the profiler's own aggregate) checks. A card is
the default and there is no fallback: without one, or when the profiler
records no device time, the run fails. `--platform cpu` attributes CPU operator time instead
(each operator's self time), labelled so in `measured`, with no device
figures.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

from . import bench
from .offline_budget import Design, full_chunk, identity, scene
from .micro import warm_profile
from .ops._lib import launch_ranges
from .utils.profiling import device_work

CHUNKS = 3
INPUT_STEP = 0.1             # gray levels added to the frames of chunk i
MIN_ROW_MS = 0.05
UNATTRIBUTED = "<unattributed>"
LAUNCHER = "uwslam_tpu_torch/ops/_lib.py"
RANGE_PREFIX = "uws_"        # `ops._lib.launch`'s ranges: the C entry points' names
# The port's own kernels (`csrc/`) by the names the profiler gives them: the
# pyramid kernel (all levels of a pyramid in one launch; K1 alone at one
# level), K2 and K3, the fused LM evaluation and the LM update.
HAND_WRITTEN = ("pyramid_kernel", "warp_sample_kernel", "bilinear_sample_kernel",
                "lm_evaluate_kernel", "lm_step_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OP_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_FRAME = re.compile(r"(uwslam_tpu_torch/[\w/]+\.py)\((\d+)\)")
_PYTHON_EVENT = re.compile(r"\.py\(\d+\): |^<built-in ")


def package_frame(name: str) -> str | None:
    """`uwslam_tpu_torch/file.py:N` of a Python event `.../file.py(N): fn`
    in the package, the launcher excepted; else None."""
    m = _FRAME.search(name)
    return f"{m.group(1)}:{m.group(2)}" if m and m.group(1) != LAUNCHER else None


def nest(events: list[dict]) -> dict[int, dict]:
    """{id(event): parent event} for the host events of one thread (each
    `ts` and `dur` in us): the parent is the innermost other event that
    contains it."""
    parent = {}
    stack: list[dict] = []
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        end = e["ts"] + e["dur"]
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < end:
            stack.pop()
        if stack:
            parent[id(e)] = stack[-1]
        stack.append(e)
    return parent


def attribute_events(events: list[dict], cuda: bool) -> dict:
    """One profile's Chrome trace events -> {"rows": {(source, op): [ms,
    launches]}, "total_ms", "span_ms"}. On a card each kernel (memory copies
    and sets included) goes through its correlation id to the runtime call
    that launched it and through that call's external id, or where it
    carries none through the nesting of its thread's events, to the
    operator or range that enclosed it; on the CPU each operator's self time (its time
    less its child operators') is its own row. The source is the innermost
    package frame among the Python events that enclose the operator."""
    by_tid = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in OP_CATS + RUNTIME_CATS + ("python_function",):
            by_tid[(e.get("pid"), e.get("tid"))].append(e)
    parent = {}
    for thread in by_tid.values():
        parent.update(nest(thread))

    def enclosing(e, cats):
        p = parent.get(id(e))
        while p is not None and p["cat"] not in cats:
            p = parent.get(id(p))
        return p

    def source(op):
        p = enclosing(op, ("python_function",))
        while p is not None and not package_frame(p["name"]):
            p = enclosing(p, ("python_function",))
        return UNATTRIBUTED if p is None else package_frame(p["name"])

    rows = defaultdict(lambda: [0.0, 0])
    ops = [e for thread in by_tid.values() for e in thread if e["cat"] in OP_CATS]
    if not cuda:
        child_us = defaultdict(float)
        for op in ops:
            p = parent.get(id(op))
            if p is not None and p["cat"] in OP_CATS:
                child_us[id(p)] += op["dur"]
        for op in ops:
            if op["cat"] == "cpu_op":
                row = rows[(source(op), op["name"])]
                row[0] += (op["dur"] - child_us[id(op)]) / 1e3
                row[1] += 1
        return {"rows": rows, "total_ms": sum(r[0] for r in rows.values()), "span_ms": None}

    op_of = {e["args"]["External id"]: e for e in ops if "External id" in e.get("args", {})}
    runtime_of = {e["args"]["correlation"]: e for thread in by_tid.values() for e in thread
                  if e["cat"] in RUNTIME_CATS and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not device:
        raise RuntimeError("torch.profiler recorded no device time: no attribution without it")
    for k in device:
        launch = runtime_of.get(k.get("args", {}).get("correlation"))
        # A launch from an operator carries its external id; a ctypes launch
        # carries none and lies in the range that encloses it on its thread.
        op = launch and (op_of.get(launch.get("args", {}).get("External id"))
                         or enclosing(launch, OP_CATS))
        if op is None:
            key = (UNATTRIBUTED, "<no operator>")
        elif op["name"].startswith(RANGE_PREFIX):
            key = (source(op), kernel_name(k["name"]))
        else:
            key = (source(op), op["name"])
        rows[key][0] += k["dur"] / 1e3
        rows[key][1] += 1
    return {"rows": rows, "total_ms": sum(k["dur"] for k in device) / 1e3,
            "span_ms": (max(k["ts"] + k["dur"] for k in device)
                        - min(k["ts"] for k in device)) / 1e3}


def profiler_total_ms(prof, cuda: bool) -> float:
    """The profiler's own total per profile: its kernel time on a card (the
    device images of host ranges left out: `device_work`), its operators' self
    time on the CPU (Python calls left out)."""
    from torch.autograd import DeviceType

    if cuda:
        return sum(a.self_device_time_total for a in device_work(prof.key_averages())) / 1e3
    return sum(a.self_cpu_time_total for a in prof.key_averages()
               if a.device_type == DeviceType.CPU and not _PYTHON_EVENT.search(a.key)) / 1e3


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments:
    `void (anonymous namespace)::k<true>(float const*)` -> `k<true>`."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ").strip()


def attribute(frames, cam, design: Design = Design(), chunks: int = CHUNKS) -> dict:
    """Profile `chunks` chunks of `frames` (+ 0.1 i) and merge their rows,
    per chunk."""
    cuda = frames.device.type == "cuda"
    inputs = [frames + INPUT_STEP * i for i in range(chunks)]
    full_chunk(frames, cam, design)                                # warm-up
    merged = defaultdict(lambda: [0.0, 0])
    totals, spans = [], []
    for x in inputs:
        if cuda:
            torch.cuda.synchronize()

        def run(x=x):
            full_chunk(x, cam, design)

        # On a card a chunk in the warm-up step takes the records a profile
        # loses at its start (`micro.warm_profile`).
        with launch_ranges():
            prof = warm_profile(run, run if cuda else lambda: None, cuda, with_stack=True)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                one = attribute_events(json.load(f)["traceEvents"], cuda)
        for key, (ms, n) in one["rows"].items():
            merged[key][0] += ms
            merged[key][1] += n
        totals.append(profiler_total_ms(prof, cuda))
        spans.append(one["span_ms"])
    rows = sorted(({"source": s, "op": o, "ms_per_chunk": ms / chunks,
                    "launches": n / chunks} for (s, o), (ms, n) in merged.items()),
                  key=lambda r: -r["ms_per_chunk"])
    attributed = [r for r in rows if r["source"] != UNATTRIBUTED]
    total = sum(totals) / chunks
    return {
        "measured": ("device kernel time (torch.profiler)" if cuda else
                     "CPU operator self time (torch.profiler), not device time"),
        "device_span_ms_per_chunk": sum(spans) / chunks if cuda else None,
        "device_busy_ms_per_chunk": total if cuda else None,
        "total_ms_per_chunk": total,
        "rows_ms_per_chunk": sum(r["ms_per_chunk"] for r in rows),
        "attribution": [r for r in attributed if r["ms_per_chunk"] >= MIN_ROW_MS],
        "below_row_ms_per_chunk": sum(r["ms_per_chunk"] for r in attributed
                                      if r["ms_per_chunk"] < MIN_ROW_MS),
        "unattributed_ms_per_chunk": sum(r["ms_per_chunk"] for r in rows
                                         if r["source"] == UNATTRIBUTED),
        "hand_written": [r for r in attributed if r["source"].startswith(
            "uwslam_tpu_torch/ops/cuda_") and any(k in r["op"] for k in HAND_WRITTEN)],
        "chunks": chunks,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="ATTR_TORCH_r10.json")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) attributes kernel time; cpu operator time")
    args = ap.parse_args(argv)
    cuda = args.platform == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("attribute_trace: --platform cuda (the default) needs a CUDA card and "
                         "none is visible")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    _, frames = scene(bench.NUM_FRAMES, device=dev)
    out = {"device": identity(cuda),
           "chunk": f"{bench.NUM_FRAMES} frames, {bench.NUM_FRAMES - 1} tracked pairs "
                    "(the bench chunk)",
           **attribute(frames, bench.CAM)}
    text = json.dumps(out, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(f"wrote {os.path.abspath(args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
