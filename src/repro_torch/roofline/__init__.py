"""repro_torch.roofline: the H100 roofline terms and the HBM-traffic model."""
