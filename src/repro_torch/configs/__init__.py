"""Model configs (own copies of ``repro.configs``)."""
