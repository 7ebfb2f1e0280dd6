"""Seeded synthetic data (the counterpart of ``repro.data``)."""
