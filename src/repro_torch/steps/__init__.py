"""Step functions of the LM substrate (``repro.steps``): the serving halves."""
