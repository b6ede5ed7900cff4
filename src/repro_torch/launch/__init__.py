"""Entry points of the port's LM stack (``repro/launch``): serving and
training."""
