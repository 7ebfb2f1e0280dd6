"""Checkpoints (the counterpart of ``repro.checkpoint``): the same
manifest and ``.npy`` layout, written and read with torch, numpy and the
standard library (``_msgpack`` holds the manifest's MessagePack
subset)."""
