"""Synthetic data: the Table 2 stand-ins (`digits`, `event_frames`) and
the LM training loop's token pipeline."""
