"""The plain reference of ZEGGS that decides ``correct``: plain PyTorch and
NumPy at float32, frozen copies of the port's plain code with no kernel,
graph, batching or cache. It imports nothing of the port or of JAX."""
