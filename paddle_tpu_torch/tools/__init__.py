"""Command-line tools of the port (``python -m paddle_tpu_torch.tools.<name>``)."""
