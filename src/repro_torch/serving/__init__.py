"""repro_torch.serving: the batched LLM engine."""
