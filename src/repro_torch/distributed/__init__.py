"""repro_torch.distributed: sharding rules as DTensor placements."""
