"""Host-side compiler and event-engine runtime of the port."""
