"""Noise schedules and the conditional diffusion engine."""
