"""The benchmark of `zeggs_tpu_torch` on NVIDIA H100 cards: cells declared in
`BENCHMARK.json`, run by ``python -m benchmark.run`` (see `run.py`)."""
