"""Host audio helpers (BS.1770 loudness)."""
