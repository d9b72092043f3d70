"""Fault tolerance for training (``fault``: failure injection, straggler
detection, step timing)."""
