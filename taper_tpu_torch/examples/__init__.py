"""Examples of the port, runnable as ``python -m
taper_tpu_torch.examples.<name>``."""
