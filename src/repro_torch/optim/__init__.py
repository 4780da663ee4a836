"""Optimizers of the LM substrate (``repro.optim``): AdamW with float32
moments and with block-wise 8-bit moments."""
