"""Checkpoints: local files and the content-addressed storage layer."""
