"""LM launchers: the train/prefill/decode step factories, the training
loop and the slot server."""
