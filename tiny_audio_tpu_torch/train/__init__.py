"""Training on PyTorch: optimizer, collator, data, augmentation, config
composition and the Trainer (``python -m tiny_audio_tpu_torch.train``)."""
