"""The LM stack's models (dense family, serving half): layers, GQA
attention over the flash kernel, the LM assembly and the converter of the
JAX package's parameters."""
