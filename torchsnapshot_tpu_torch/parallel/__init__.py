"""Geometry of sharded state (``overlap.py``)."""
