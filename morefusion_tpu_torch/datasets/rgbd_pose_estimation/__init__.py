"""Per-instance pose-estimation examples of the port: the frame factory,
the synthetic frame source, the reindexed store and its augmentation."""
