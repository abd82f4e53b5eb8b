"""Per-clip features, the corpus pipeline, the windowed dataset and the device corpus."""
