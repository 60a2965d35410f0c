"""K7 (the flash-attention forward) at the serve phase's long prefill
shape, (1, 4096, 32, 4, 64) bf16 causal, timed in the checkout at ROOT:
eager (CUDA events over back-to-back launches), CUDA-graph replay
(device time alone) and the wrapper's host time per call.

    python examples/torch_k7_time.py ROOT

Compare two commits on one card: unpack the other one with `git
archive` into a directory `.gitignore` lists and run this for each
checkout in turns (A B B A), in one command. Needs a CUDA card.
"""
import sys
import time


def main(root: str) -> None:
    sys.path.insert(0, root + "/src")
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kf
    _build.build()
    _build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((1, 4096, 32, 64), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((1, 4096, 4, 64), generator=g, device=dev).bfloat16()
            for _ in range(2))

    def fn():
        return kf.flash_attention(q, k, v)

    def eager_ms(iters=50):
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

    def graph_ms(iters=20):
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

    def host_us(iters=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / iters * 1e6

    print(f"K7 {root}: eager ms {[eager_ms() for _ in range(3)]}, graph ms "
          f"{[graph_ms() for _ in range(3)]}, host us per call {host_us()}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
