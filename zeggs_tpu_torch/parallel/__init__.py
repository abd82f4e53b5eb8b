"""Data parallelism (counterpart of `zeggs_tpu/parallel/`).

Generation: `mesh.py` makes a one-axis mesh of devices in one process, and
`infer/batch.py::generate_batch(mesh=...)` splits a chunk's rows over it,
as `zeggs_tpu` shards its batch over a ('data',) mesh.

Training makes no mesh. `zeggs_tpu` lays its mesh over every device and
lets XLA insert the gradient all-reduce; here each process owns one card
(or the CPU), holds the whole model, takes its rows of the global batch
and averages its gradients with the others' through `torch.distributed`
(`distributed.py`), PyTorch's own form. The mesh module's one rule that
carries over to training, that the global batch divides evenly over the
devices (`create_mesh_for_batch`), is the Trainer's check that the batch
size divides by the number of processes.
"""

from .mesh import Mesh, create_mesh, create_mesh_for_batch, shard_rows  # noqa: F401
