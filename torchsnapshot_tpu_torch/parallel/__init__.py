"""Geometry of sharded state (``overlap.py``) and the GPipe schedule
over a ``pp`` mesh dimension (``pipeline.py``)."""
from .overlap import Box  # noqa: F401
from .pipeline import (  # noqa: F401
    pipeline_stage_shardings,
    pipelined_apply,
    stack_stage_params,
)
