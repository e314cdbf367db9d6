"""uwslam_tpu_torch — the PyTorch and CUDA port of uwslam_tpu.

README configurations 1 to 7: offline odometry (`tracking`), the live
system (`system.SlamSystem`: tracking, keyframes, relocalization, the
feature front end and depth bootstrap, window bundle adjustment, loop
closure, the global landmark-sharded BA of `parallel`), the CLI (`cli.main`,
also `python -m uwslam_tpu_torch`), the evaluation of eval.py's configs
(`eval`) and the per-op micro benchmark (`micro`), with hand-written CUDA
kernels for Hopper (`ops/`, sources in `csrc/`). The JAX package
`uwslam_tpu` is the reference each module is tested against; this package
never imports JAX.
"""
