"""Typed parallelisation plans (the counterpart of ``repro.parallel``):
so far the context-parallel half, ``ContextPlan`` and ``plan_context``."""
from .plan import ContextPlan  # noqa: F401
from .api import plan_context  # noqa: F401
