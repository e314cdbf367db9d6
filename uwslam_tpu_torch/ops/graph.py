"""A function of tensors captured once into a CUDA graph and replayed.

The live frame is thousands of small launches (the LM loop's plain
operations around the kernels), each costing the host more than the card;
replayed as one `torch.cuda.CUDAGraph` the host pays one launch. A graph
fixes the addresses of everything it touches, so `CapturedStep` owns static
input tensors, copies each call's arguments into them before the replay
(outside the graph: a copy from pageable host memory may not be captured),
and returns the graph's output tensors, which the next replay overwrites:
the caller clones what it keeps.

The kernels' wrappers count their launches in Python, which a replay does
not run. So the count of every wrapper is read around the capture (a
captured launch is recorded, not run, and is taken back off the count) and
added at every replay, where the kernels do run.

A capture or a replay that fails raises; nothing falls back to eager calls.
"""
from __future__ import annotations

import torch

from .cuda_lm import lm_step
from .cuda_pyramid import cuda_build_pyramid, scharr_gradients_batched
from .cuda_sample import cuda_bilinear_sample
from .cuda_track import lm_evaluate, warp_and_sample

COUNTED = (cuda_build_pyramid, warp_and_sample, cuda_bilinear_sample, lm_evaluate,
           scharr_gradients_batched, lm_step)
WARMUP_CALLS = 3


def tree_map(fn, x):
    """`fn` on every tensor of a nest of tuples and named tuples; whatever is
    neither (None, a named tuple's int field) stays."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if not isinstance(x, tuple):
        return x
    items = [tree_map(fn, v) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def tree_leaves(x) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    tree_map(out.append, x)
    return out


def tree_clone(x):
    return tree_map(torch.clone, x)


class CapturedStep:
    """`fn(*inputs) -> outputs` (nests of CUDA tensors) as a CUDA graph.

    `example_inputs` fix the structure, shapes and dtypes; they are cloned
    into the static inputs. `fn` runs WARMUP_CALLS times on a side stream
    (which builds and loads the kernels, and lets the libraries make their
    handles and workspaces) and is then captured once."""

    def __init__(self, fn, example_inputs: tuple):
        leaves = tree_leaves(example_inputs)
        if not leaves or any(t.device.type != "cuda" for t in leaves):
            raise ValueError("a CUDA graph captures a function of CUDA tensors")
        self._inputs = tree_clone(example_inputs)
        self._in_leaves = tree_leaves(self._inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*self._inputs)
        torch.cuda.current_stream().wait_stream(side)
        before = [w.launches for w in COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self._inputs)
        self.kernel_launches = tuple(w.launches - b for w, b in zip(COUNTED, before))
        for w, b in zip(COUNTED, before):
            w.launches = b
        self.replays = 0

    def clear_inputs(self) -> None:
        """Zero the static inputs: nothing of the last call's arguments
        stays on the card (a replay copies its own in first)."""
        for t in self._in_leaves:
            t.zero_()

    def __call__(self, *inputs):
        """Copy `inputs` into the static inputs, replay, and return the static
        outputs (valid until the next call)."""
        src = tree_leaves(inputs)
        if len(src) != len(self._in_leaves):
            raise ValueError("inputs do not have the captured structure")
        for dst, s in zip(self._in_leaves, src):
            if dst.shape != s.shape or dst.dtype != s.dtype:
                raise ValueError(
                    f"input {tuple(s.shape)} {s.dtype} does not match the captured "
                    f"{tuple(dst.shape)} {dst.dtype}"
                )
            dst.copy_(s, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        for w, n in zip(COUNTED, self.kernel_launches):
            w.launches += n
        return self.outputs
