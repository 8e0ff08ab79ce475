"""Command-line entry points of the port, one module per dataset and
sensor (``python -m active_orb_slam2_tpu_torch.examples.<name> --help``);
the counterparts of the repository's ``examples/``."""
