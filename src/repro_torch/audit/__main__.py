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

Runs on the card unless ``--device cpu``. ``--mesh`` (the reference's
sharded build) raises: the port has no mesh yet (ROADMAP Queue 1 item 4).
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
                    help="the reference's sharded build (not ported)")
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

    from repro_torch.audit.registry import run_passes
    from repro_torch.audit.targets import build_context

    only = args.passes.split(",") if args.passes else None
    ctx = build_context(args.arch, reduced=args.reduced,
                        mesh_shape=args.mesh, mutate=args.mutate,
                        serve=args.serve, device=args.device)
    report = run_passes(ctx, only=only)
    print(report.render())
    if not args.no_json:
        payload = report.to_dict()
        payload["tables"] = ctx.tables()
        path = os.path.join(args.out, f"AUDIT_torch_{ctx.config_key}.json")
        os.makedirs(args.out or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        print(f"wrote {path}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
