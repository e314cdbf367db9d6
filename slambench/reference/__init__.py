"""The plain references of the output check: the same semantics as the system
under test, written out in plain PyTorch from the configuration's flags,
with no kernel, graph or batching, and independent of the program (they
import neither `uwslam_tpu_torch` nor JAX nor the JAX package).

A configuration names its reference by the key `"reference"`: the module
`slambench/reference/<module>.py`, which `spec.load_cell` loads as a
submodule of this package. The harness runs every comparison through it,
so a configuration that needs another reference brings a new module and no
edit here. A reference module gives:

- `NUMBERS`: the names of the numbers it compares. The configuration's
  limits file (`limits/<config>.json`) holds exactly these and
  `min_compared`, in the order the check prints them.
- `settings(config)`: the configuration's flags as the reference reads
  them; raises `ValueError` naming a flag it does not implement.
  `load_cell` calls it, so a configuration the reference cannot check is
  refused before any set-up, and `reference` reads the flags through it
  alone.
- `keep(rec, prev)`: what the sample holds of a record that the system's
  `_dispatch_pipelined` returned; `prev` is the record dispatched just
  before it, or None. It runs on the timed path, so it takes references
  only: no copy, no read to the host, no sync.
- `answer(frame_id, kept, states)`: after the window, the program's answer
  for a sampled frame from what `keep` held and the trajectory's states by
  frame id, together with what the reference takes from the program's
  state; None where the frame is not comparable.
- `reference(ring, answer, config, device)`: the reference's answer for
  that frame, worked out again from the harness's own 8-bit frames. Its
  keys are the ones `compare` reads in the program's answer, so the
  control (the reference at the precision below) can stand in the
  program's place.
- `compare(answer, ref)`: one row of numbers for one frame.
- `summarize(rows)`: one number per name in `NUMBERS`, nan where there are
  no rows.
"""
