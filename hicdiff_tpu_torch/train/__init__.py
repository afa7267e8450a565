"""Checkpoint reading (training itself is not ported yet)."""
