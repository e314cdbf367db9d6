"""uwslam_tpu_torch — the PyTorch and CUDA port of uwslam_tpu.

The offline direct-odometry path (`tracking.SequenceTracker`, IC mode) with
hand-written CUDA kernels for Hopper (`ops/`, sources in `csrc/`). The JAX
package `uwslam_tpu` is the reference each module is tested against; this
package never imports JAX.
"""
