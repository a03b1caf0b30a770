"""The port's measurement scripts, each the counterpart of one under the
repository's ``scripts/``, run as ``python -m grayscott_tpu_torch.scripts.<name>``."""
