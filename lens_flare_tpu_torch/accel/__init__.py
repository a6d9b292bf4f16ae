"""Acceleration structures: the two-level cluster tree and its native builder."""
