"""Step builders and model initialisation for the LM stack."""
