"""The LM substrate's models (``repro.models``): the decoder's serving path
(:mod:`~repro_torch.models.decoder`) for the dense, MoE and hybrid
families, its attention over the CUDA kernels of
:mod:`repro_torch.kernels.attention`, the RG-LRU block
(:mod:`~repro_torch.models.rglru`) and
:func:`~repro_torch.models.registry.build_model`."""
