"""K7 (the flash-attention forward) at the serve phase's long prefill
shape, (1, 4096, 32, 4, 64) bf16 causal, or with ``--bwd`` K7b (its
backward) at one microbatch's attention in tinyllama-train, (2, 4096, 32,
4, 64) bf16 causal, timed in the checkout at ROOT: eager (CUDA events over
back-to-back launches), CUDA-graph replay (device time alone) and the
wrapper's host time per call; with ``--bwd`` also the backward of
``scaled_dot_product_attention`` on the same tensors (eager, timed in
turns with K7b: kernel, library, library, kernel).

    python examples/torch_k7_time.py ROOT [--bwd]

Compare two commits on one card: unpack the other one with `git
archive` into a directory `.gitignore` lists and run this for each
checkout in turns (A B B A), in one command. Needs a CUDA card.
"""
import argparse
import sys
import time


def eager_ms(fn, iters=50):
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters=20):
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
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (2 * iters)


def host_us(fn, iters=200):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def main(root: str, bwd: bool) -> None:
    sys.path.insert(0, root + "/src")
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kf
    _build.build()
    _build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    B = 2 if bwd else 1
    q = torch.randn((B, 4096, 32, 64), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, 4096, 4, 64), generator=g, device=dev).bfloat16()
            for _ in range(2))
    if not bwd:
        def fn():
            return kf.flash_attention(q, k, v)

        print(f"K7 {root}: eager ms {[eager_ms(fn) for _ in range(3)]}, "
              f"graph ms {[graph_ms(fn) for _ in range(3)]}, host us per "
              f"call {host_us(fn)}")
        return
    dout = torch.randn(q.shape, generator=g, device=dev).bfloat16()
    out, lse = kf.flash_attention_lse(q, k, v)

    def fn():
        return kf.flash_attention_bwd(q, k, v, out, dout, lse)

    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    with torch.enable_grad():
        o_lib = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=True)
    d_lib = dout.transpose(1, 2)

    def lib():
        return torch.autograd.grad(o_lib, leaves, d_lib, retain_graph=True)

    turns = [eager_ms(f, 20) for f in (fn, lib, lib, fn)]
    print(f"K7b {root}: eager ms {[eager_ms(fn, 20) for _ in range(3)]}, "
          f"graph ms {[graph_ms(fn) for _ in range(3)]}, host us per call "
          f"{host_us(fn, 50)}; in turns kernel {turns[0]} {turns[3]}, sdpa "
          f"backward {turns[1]} {turns[2]}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--bwd", action="store_true",
                    help="time K7b and SDPA's backward instead of K7")
    args = ap.parse_args()
    main(args.root, args.bwd)
