"""Training-loop supervision: the step watchdog."""
