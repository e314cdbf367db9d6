"""Command line of the port (`python -m uwslam_tpu_torch.cli.main`)."""
