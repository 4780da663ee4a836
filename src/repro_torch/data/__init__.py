"""Spatial dataset generators (numpy, carried over from ``repro.data``)."""
