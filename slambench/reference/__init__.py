"""The plain reference of the output check: the same semantics as the system
under test, written out in plain PyTorch from the configuration's flags,
with no kernel, graph or batching, and independent of the program (it
imports neither `uwslam_tpu_torch` nor JAX nor the JAX package)."""
