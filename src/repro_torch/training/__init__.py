"""repro_torch.training: AdamW, int8 gradient compression and the train step."""
