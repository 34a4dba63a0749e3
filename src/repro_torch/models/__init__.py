"""LM substrate of the PyTorch port: every family of the reference, served
and trained on the card (``registry.get_model``), with the attention of
prefill / forward on the hand-written ``flash_attention`` kernel when
``attn_impl='kernel'`` (serving only: it has no backward)."""
