"""repro_torch.models: the LM families of ``repro.models`` in PyTorch."""
