"""Checkpoints of serving state (engine snapshots) on disk."""
