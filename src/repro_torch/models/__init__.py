"""LM models of the port: the dense decoder family (config, attention
with the flash prefill kernel, FFN, the stack, weight conversion)."""
