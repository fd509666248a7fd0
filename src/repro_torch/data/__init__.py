"""Data for the LM stack: the synthetic token pipeline."""
