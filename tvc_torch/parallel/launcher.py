"""The launcher of a sweep over several processes (counterpart of
``tvc/parallel/launcher.py``).

One invocation per process:

    TVC_COORDINATOR=host0:1234 TVC_NUM_PROCESSES=4 TVC_PROCESS_ID=$i \\
        python -m tvc_torch.parallel.launcher sweep --data-npy ... --batched 8 ...

It joins the processes into one group from the ``TVC_*`` variables, appends
``--num-processes`` and ``--process-id`` to a ``sweep`` and hands the rest
of the command line to ``tvc_torch.cli``. Each process owns whole GOP
chains on its own device (a chain's serial dependency stays local) and runs
its static share of the threshold walks (``partition_work``).

The group is gloo, whatever the device: the JAX package's
``jax.distributed.initialize`` starts a coordination service between hosts,
not a device collective, and a sweep exchanges no tensors. Gloo coordinates
hosts, and it lets two launcher processes share one card, which NCCL
refuses. ``initialize_distributed`` defaults to NCCL for a CUDA device
because training and ``run_sharded`` move tensors between cards.
"""

from __future__ import annotations

import os
import sys

import torch.distributed as dist


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    num = int(os.environ.get("TVC_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("TVC_PROCESS_ID", "0"))
    coord = os.environ.get("TVC_COORDINATOR")

    from tvc_torch.parallel.mesh import initialize_distributed

    initialize_distributed(coordinator=coord, num_processes=num, process_id=pid, device="cpu")
    if argv and argv[0] == "sweep":
        argv = argv + ["--num-processes", str(num), "--process-id", str(pid)]

    from tvc_torch.cli import main as cli_main

    try:
        return cli_main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
