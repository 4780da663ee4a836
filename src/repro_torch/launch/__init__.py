"""Serving entry points of the port (``repro.launch``).

Only :mod:`repro_torch.launch.serve`'s deprecated ``RkNNServer`` alias and
its ``batched_raycast_counts`` are here; the JAX package's dry-run
lowering and the LM launchers belong to its LM substrate.
"""
