"""Train-step builders (the counterpart of ``repro.training``)."""
