"""Optimizers of the LM stack."""
