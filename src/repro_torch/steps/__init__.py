"""Step functions of the LM substrate (``repro.steps``): the training step
and its loss, and the serving halves."""
