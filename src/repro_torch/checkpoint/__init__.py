"""repro_torch.checkpoint: atomic checkpoints and the heartbeat runtime."""
