"""Training runtime hooks of the LM substrate (``repro.runtime``): the
int8 error-feedback gradient compression."""
