"""CPU tests of the benchmark: the reference against the port, the work
count, the control and the faults, isolation and discovery."""
