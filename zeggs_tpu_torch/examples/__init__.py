"""Runnable examples of the port (``python -m zeggs_tpu_torch.examples.<name>``)."""
