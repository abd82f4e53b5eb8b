"""Multi-process data-parallel training (counterpart of `zeggs_tpu/parallel/`).

`zeggs_tpu` lays a ('data',) device mesh over every device and lets XLA
insert the gradient all-reduce. PyTorch has no counterpart of that mesh,
and none is made here: each process owns one card (or the CPU), holds the
whole model, takes its rows of the global batch and averages its gradients
with the others' through `torch.distributed` (`distributed.py`). The mesh
module's one rule that carries over, that the global batch divides evenly
over the devices (`create_mesh_for_batch`), is the Trainer's check that the
batch size divides by the number of processes.
"""
