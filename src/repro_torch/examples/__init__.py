"""Runnable examples of the port (counterparts of the repo's
``examples/*.py``): ``python -m repro_torch.examples.<name> --device cpu``."""
