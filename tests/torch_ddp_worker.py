"""One process of a two-process gloo group for tests/test_torch_ddp.py
(on the CPU) and tests/test_torch_cuda.py (two processes sharing a card):
the port's training CLI with the multi-process flags, or with none of them
and torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``) set.

argv: coordinator_address num_processes process_id options_json
      max_iterations host_batches(0|1) [training CLI flags ...]
with "env" for each of the first three to take the environment instead;
the flags after them go to the CLI last (``--device cuda`` overrides the
CPU).
"""

import sys
from pathlib import Path


def main():
    address, nproc, pid, options, n_iter, host_batches = sys.argv[1:7]
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    torch.set_num_threads(1)
    from zeggs_tpu_torch.cli import train
    from zeggs_tpu_torch.parallel import distributed

    argv = ["-o", options, "--device", "cpu", "--max-iterations", n_iter]
    if address != "env":
        argv += ["--coordinator-address", address, "--num-processes", nproc, "--process-id", pid]
    trainer = train.main(argv + (["--host-batches"] if int(host_batches) else []) + sys.argv[7:])
    print(f"process {trainer.rank} of {trainer.world}, "
          f"local rank {distributed.local_rank()}: done at iteration {trainer.iteration}",
          flush=True)


if __name__ == "__main__":
    main()
