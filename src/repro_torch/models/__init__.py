"""The LM stack's models (dense family): layers and the chunked loss, GQA
attention over the flash kernels, the LM assembly (loss, prefill,
decode) and the converters of the JAX package's parameters and AdamW
state."""
