"""Architecture configs of the LM substrate (``repro.configs``), copied:
one module per architecture with its published ``CONFIG``, resolved by
:func:`repro_torch.configs.registry.get_config` and ``get_reduced``."""
