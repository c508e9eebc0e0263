"""Runnable entries of the port (``python -m distributed_training_pytorch_tpu_torch.examples.<name>``)."""
