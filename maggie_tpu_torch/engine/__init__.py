"""Engines of the port: image evaluation (``test.py``)."""
