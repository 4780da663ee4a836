"""Optimizers of the LM substrate (``repro.optim``): AdamW."""
