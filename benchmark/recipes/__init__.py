"""Recipes of the traffic generator, one a ``kind`` (``generator.py``)."""
