"""Per-clip feature extraction."""
