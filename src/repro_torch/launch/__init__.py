"""Entry points of the port (``repro.launch``).

:mod:`repro_torch.launch.serve` holds the deprecated ``RkNNServer`` alias
and its ``batched_raycast_counts``; :mod:`repro_torch.launch.train` the
LM training launcher (``train_main``, ``python -m
repro_torch.launch.train``).  The JAX package's dry-run lowering and its
other LM launchers are not ported yet.
"""
