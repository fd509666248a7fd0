"""Training-loop supervision (the step watchdog, `elastic`) and the mesh
tier's process groups (`mesh`)."""
