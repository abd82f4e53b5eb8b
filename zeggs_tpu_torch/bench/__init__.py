"""The port's benchmark: `bench.py` and its stage scripts for the card.

    python -m zeggs_tpu_torch.bench            # every stage, on the card
    python -m zeggs_tpu_torch.bench --quick    # a depth cut, at full width
    python -m zeggs_tpu_torch.bench --device cpu --tiny   # a rehearsal

`__main__` is the orchestrator (`bench.py`'s): each stage runs in a process
of its own and prints one JSON line; the orchestrator prints the headline
line after the core stage and again after every later stage. The stages:
`core` (batched frames/s, int8 frames/s, B=1 latencies), `serve` (a
20-request corpus through `generate_batch`, the HTTP daemon and sequential
requests), `streaming` (a live session, in process and over HTTP) and
`train` (the captured train step, float32 and bfloat16); `fixture` holds
what they share. Nothing here imports ``jax`` or `zeggs_tpu`.
"""
