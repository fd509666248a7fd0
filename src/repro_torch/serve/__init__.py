"""Serving primitives, copied from `repro/serve/`: the LM slot server's
`SlotPool` and `BufferFull` now, the spike server's double buffer for
the serving slice."""
