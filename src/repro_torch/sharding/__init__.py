"""Logical-axis sharding rules and tensor-parallel padding."""
