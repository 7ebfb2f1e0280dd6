"""Launch scripts (the counterpart of ``repro.launch``): the
single-process training launcher, ``python -m repro_torch.launch.train``."""
