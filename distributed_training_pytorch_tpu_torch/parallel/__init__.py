"""Data parallelism over ``torch.distributed`` (``mesh``)."""
