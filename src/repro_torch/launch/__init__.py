"""LM launchers: the prefill/decode step factories and the slot server."""
