"""The benchmark's own count of the work a step needs, from the spec
columns and the spikes of the steps counted; no layout of the program's
tables enters it."""
