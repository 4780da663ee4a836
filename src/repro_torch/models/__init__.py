"""The LM substrate's models (``repro.models``): the dense decoder's
serving path (:mod:`~repro_torch.models.decoder`), its attention over the
CUDA kernels of :mod:`repro_torch.kernels.attention`, and
:func:`~repro_torch.models.registry.build_model`."""
