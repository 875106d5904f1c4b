"""One process of the port's multi-process run (not collected by pytest;
driven by ``tests/test_torch_multihost.py``).

The launcher sets the environment ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and ``CIAO_MULTIHOST``; the process joins the gloo group
through ``init_method="env://"`` (``parallel.mesh.process_group``, as
``examples_torch/multihost.py`` does), runs ``torch_parallel_worker``'s
``multihost`` runs on the CPU, and rank 0 writes them to
``<outdir>/multihost.pt``. Imports no JAX.

    python tests/torch_multihost_worker.py <outdir>
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_parallel_worker as tw  # noqa: E402
from ciao_tpu_torch.parallel import make_mesh  # noqa: E402
from ciao_tpu_torch.parallel.mesh import process_group  # noqa: E402


def main(outdir: str) -> None:
    torch.set_num_threads(1)
    assert os.environ.get("CIAO_MULTIHOST")
    with process_group("cpu"):
        assert dist.get_backend() == "gloo"
        out = tw.multihost(make_mesh(device="cpu"), {})
        out["world"] = dist.get_world_size()
        if dist.get_rank() == 0:
            torch.save(out, os.path.join(outdir, "multihost.pt"))
        dist.barrier()


if __name__ == "__main__":
    main(sys.argv[1])
