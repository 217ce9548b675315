"""Model pieces shared with the LM stack (only the dispatch so far)."""
