"""The harness: finds a cell's files by name, builds its network from
the seed, drives the program, reads the trace and decides `correct`."""
