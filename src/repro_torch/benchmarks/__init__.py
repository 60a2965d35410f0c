"""The paper's benchmarks on the port (``paper_benches.py``), written to
``BENCH_torch_<suite>.json`` by ``python -m repro_torch.benchmarks.run``."""
