"""LM substrate of the PyTorch port: the dense decoder family served on the
card (``registry.get_model``), with the attention of prefill / forward on
the hand-written ``flash_attention`` kernel when ``attn_impl='kernel'``."""
