"""Training runtime of the LM substrate (``repro.runtime``): the int8
error-feedback gradient compression, the straggler watchdog and hang timer,
elastic re-meshing and the fault-tolerant training driver."""
