"""The port's decoder-only LM (``repro/models``) and the converter that
loads the JAX model's parameters into it."""
