"""Deterministic synthetic datasets (numpy, seeded)."""
