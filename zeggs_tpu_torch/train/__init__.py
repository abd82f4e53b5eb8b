"""Training: the 18-term loss, RAdam and the single-card trainer."""
