"""K1 (the streaming Gram row, ``kernels/arena.py::gram_row``) timed in the
checkout at ROOT on the rings the main paths give it: the paper MLP's
arena (5633, 14, 512) fp32 with its own block -> system table, and bf16
rings of LM size, qwen3-moe-train's (3,648,512, 8, 512) in 16 systems and
mamba2-train's at 32 layers (2,764,144 x 14 x 512; 289 systems, here of
equal size). The LM rings hold snapshot-like rows
(x_j = w + j d, so that the anchored products share a sign, as on a
training run's ring). For each: eager ms (CUDA events over back-to-back
launches), CUDA-graph replay ms, and the largest distance of K1's row
from a float64 twin beside the chunked fp32 twin's.

    python examples/torch_k1_time.py ROOT

Compare two commits on one card: unpack the other one with `git
archive` into a directory `.gitignore` lists and run this for each
checkout in turns (A B B A), in one command. Needs a CUDA card.
"""
import sys
import time

RINGS = (("moe", 3_648_512, 8, 16), ("mamba2", 2_764_144, 14, 289))


def eager_ms(fn, iters=10):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters=5):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def f64_row(x, q, block_sys, n_sys, chunk=1 << 16):
    """K1's float64 twin, anchored at row 0, a block range at a time."""
    import torch
    out = torch.zeros((n_sys, x.shape[1]), dtype=torch.float64,
                      device=x.device)
    idx = block_sys.to(x.device, torch.long)
    for a in range(0, x.shape[0], chunk):
        xs, qs = x[a:a + chunk].double(), q[a:a + chunk].double()
        qs = qs - xs[:, 0, :]
        xs = xs - xs[:, 0:1, :]
        out.index_add_(0, idx[a:a + chunk],
                       torch.bmm(xs, qs.unsqueeze(-1)).squeeze(-1))
    return out


def measure(name, x, seg, ka):
    import torch
    m = x.shape[1]
    q = x[:, m - 1, :]
    kern = lambda: ka.gram_row(x, q, seg, anchor_first=True)  # noqa: E731
    exact = f64_row(x, q, seg.block_sys, seg.n_sys)
    err = float((kern().double() - exact).abs().max())
    twin = sum(ka.gram_row_ref(x[a:a + (1 << 16)], q[a:a + (1 << 16)],
                               seg.block_sys[a:a + (1 << 16)], seg.n_sys,
                               anchor_first=True)
               for a in range(0, x.shape[0], 1 << 16))
    t_err = float((twin.double() - exact).abs().max())
    same = torch.equal(kern(), kern())
    print(f"K1 {name} {tuple(x.shape)} {x.dtype} n_sys {seg.n_sys}: eager "
          f"{eager_ms(kern)} ms, replay {graph_ms(kern)} ms; max_abs_err "
          f"{err} from the float64 twin, the chunked fp32 twin's {t_err} "
          f"({err / max(t_err, 1e-300)}x); repeat bit-identical {same}; "
          f"row scale {float(exact.abs().max())}", flush=True)


def main(root: str) -> None:
    sys.path.insert(0, root + "/src")
    import numpy as np
    import torch
    from repro_torch.configs.base import DMDConfig
    from repro_torch.configs.pollutant_mlp import PAPER_SIZES
    from repro_torch.core.accelerator import DMDAccelerator
    from repro_torch.kernels import _build
    from repro_torch.kernels import arena as ka
    from repro_torch.models.mlp_net import init_mlp
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"{root}: build {time.perf_counter() - t0} s", flush=True)
    dev = torch.device("cuda")
    params = init_mlp(torch.Generator().manual_seed(0), PAPER_SIZES,
                      device=dev)
    (bucket,) = DMDAccelerator(DMDConfig(), device=dev).arena_for(
        params).values()
    seg = bucket.tables_on(dev)
    x = torch.randn((bucket.n_blocks, bucket.m, bucket.block_n),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    measure("paper arena", x, seg, ka)
    del x
    for name, nb, m, n_sys in RINGS:
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.empty((nb, m, 512), dtype=torch.bfloat16, device=dev)
        for a in range(0, nb, 1 << 16):
            n = min(1 << 16, nb - a)
            w = 0.02 * torch.randn((n, 1, 512), generator=g, device=dev)
            d = 1e-3 * torch.randn((n, 1, 512), generator=g, device=dev)
            j = torch.arange(m, device=dev, dtype=torch.float32)[:, None]
            x[a:a + n] = (w + j * d).to(torch.bfloat16)
        bs = np.repeat(np.arange(n_sys), -(-nb // n_sys))[:nb]
        measure(f"{name} ring", x, ka.Segments.from_block_sys(bs, n_sys, dev),
                ka)
        del x
        torch.cuda.empty_cache()
    print(f"card: {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main(sys.argv[1])
