"""Spatial decomposition of the domain into shards (``parallel/halo.py``)."""
