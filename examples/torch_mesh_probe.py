"""gloo's collectives on CUDA tensors between four ranks on one card: each
checked once, then timed at 4, 64 and 256 MB (all-reduce over the data
axis of a (2, 2) mesh, over both axes, and an all-gather over both).

    python examples/torch_mesh_probe.py

The rates bound what a mesh step of ranks sharing one card can take: a
step all-gathers the params and all-reduces the gradient through them.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402


def rank_fn(rank):
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh((2, 2), device="cuda")
    out = {}
    t = torch.full((1000,), float(rank), device="cuda")
    mesh.all_reduce(t, ("data", "model"))
    out["all_reduce"] = float(t[0])
    b = torch.full((10,), float(rank + 1), device="cuda")
    mesh.broadcast(b)
    out["broadcast"] = float(b[0])
    parts = mesh.all_gather(torch.full((4,), float(rank), device="cuda"),
                            ("data", "model"))
    out["all_gather"] = [float(p[0]) for p in parts]
    for mb in (4, 64, 256):
        x = torch.ones((mb * 2 ** 18,), device="cuda")
        mesh.all_reduce(x, ("data",))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            mesh.all_reduce(x, ("data",))
        torch.cuda.synchronize()
        out[f"ar_{mb}MB_data_s"] = (time.perf_counter() - t0) / 3
        t0 = time.perf_counter()
        mesh.all_reduce(x, ("data", "model"))
        torch.cuda.synchronize()
        out[f"ar_{mb}MB_world_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh.all_gather(x, ("data", "model"))
        torch.cuda.synchronize()
        out[f"ag_{mb}MB_world_s"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    from repro_torch.launch.mesh import run_ranks

    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    res = run_ranks(rank_fn, 4, join_timeout=300, threads=2)
    print("wall", time.perf_counter() - t0)
    for r, o in enumerate(res):
        print(r, o)
