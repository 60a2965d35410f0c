"""CLI: ``PYTHONPATH=src python -m repro_torch.audit --arch <name>``.

    python -m repro_torch.audit --arch A [--reduced] [--serve]
        [--mutate M] [--passes P,Q] [--device cpu|cuda] [--out DIR]

Prints the text report, writes ``AUDIT_torch_<config_key>.json`` (the
report and the static plan / schedule / arena tables) under ``--out``,
and exits nonzero iff a pass records an error. ``--mutate`` seeds a named
violation (``repro_torch.audit.mutations``) to prove a pass bites:

    python -m repro_torch.audit --arch pollutant-mlp --reduced \\
        --device cpu                                        # clean, rc 0
    python -m repro_torch.audit --arch pollutant-mlp --reduced \\
        --device cpu --mutate drop-donation                 # rc 1

Runs on the card unless ``--device cpu``. ``--mesh DxM`` audits the
sharded build: it spawns D*M ranks (``launch/mesh.py::run_ranks``; all on
the one card, or on the CPU, through gloo unless ``--backend nccl``), each
builds and records the same targets on its blocks, rank 0's report is
printed and written, and the exit code is nonzero iff any rank's report
has an error. ``--mutate force-allgather`` needs ``--mesh``.
"""
import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.audit",
        description="the port's invariant auditor")
    ap.add_argument("--arch", required=True,
                    help="arch config name (repro_torch.configs)")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the model to the audit's reduced size")
    ap.add_argument("--mesh", default=None,
                    help="audit the sharded build on a DxM mesh of ranks")
    ap.add_argument("--backend", default="gloo",
                    help="the ranks' process-group backend (gloo: ranks "
                         "share one card or the CPU; nccl: a card each)")
    ap.add_argument("--mutate", default=None,
                    help="seed a named violation (repro_torch.audit."
                         "mutations)")
    ap.add_argument("--serve", action="store_true",
                    help="also drive the serving engine and run the "
                         "serve-compile pass over it")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of passes to run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=".",
                    help="directory for AUDIT_torch_<config_key>.json "
                         "(default .)")
    ap.add_argument("--no-json", action="store_true",
                    help="skip the JSON report")
    args = ap.parse_args(argv)

    from repro_torch.audit import audit_rank

    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh, run_ranks
        shape = parse_mesh(args.mesh)
        world = 1
        for d in shape:
            world *= d
        results = run_ranks(audit_rank, world, vars(args), shape,
                            backend=args.backend, join_timeout=600)
    else:
        results = [audit_rank(0, vars(args), None)]
    ok, text, key, payload = results[0]
    print(text)
    if not args.no_json:
        path = os.path.join(args.out, f"AUDIT_torch_{key}.json")
        os.makedirs(args.out or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        print(f"wrote {path}")
    bad = [r for r, res in enumerate(results) if not res[0]]
    if bad and bad != [0]:
        print(f"ranks with errors: {bad}")
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
