"""Domain decomposition: one process per rank over torch.distributed."""
