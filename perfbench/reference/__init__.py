"""The plain reference of the network's semantics, in plain PyTorch on
the benchmark's own spec columns. It imports nothing of the program."""
