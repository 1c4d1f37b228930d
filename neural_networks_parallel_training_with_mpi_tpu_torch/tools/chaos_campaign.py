"""Chaos-campaign runner: planned failures as a gate.  The port's
counterpart of the repository's ``tools/chaos_campaign.py``.

Drives the port's ``utils/chaos.py``: load a plan (builtin ``lite``/
``full`` or a JSON file), run every scenario ``--repeat`` times against
real processes, check every invariant (request-ledger exactness, no
duplicate deliveries, goodput classifying 100% of wall-clock, the
advance-notice arm's rollback/relaunch_gap/requeue at zero,
retired-stays-down), and check that the campaign is deterministic: the
wall-clock-free canonical digest must be identical across passes.

The exit code is the gate: 0 when every invariant holds and the digests
match, 1 otherwise.  ``chaos.py`` is loaded by file path, so the ``lite``
plan (supervised stdlib children) runs under ``python -S`` with no
torch.  Fleet scenarios run their workers on ``--platform`` (``gpu``,
the default: the card, or the no-CUDA error; ``cpu``: the plain PyTorch
path)::

    python -S neural_networks_parallel_training_with_mpi_tpu_torch/tools/chaos_campaign.py lite
    python neural_networks_parallel_training_with_mpi_tpu_torch/tools/chaos_campaign.py \\
        full --repeat 2 --json out.json
    python neural_networks_parallel_training_with_mpi_tpu_torch/tools/chaos_campaign.py \\
        my_plan.json --seed 7 --platform cpu
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

_CHAOS_PY = pathlib.Path(__file__).resolve().parent.parent / "utils" / "chaos.py"


def _load_chaos():
    spec = importlib.util.spec_from_file_location("_cc_chaos", _CHAOS_PY)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_cc_chaos"] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run a deterministic chaos campaign and gate on "
                    "its invariants")
    ap.add_argument("plan", help="builtin plan name (lite, full) or a "
                                 "JSON plan file")
    ap.add_argument("--repeat", type=int, default=2,
                    help="passes over the plan; >= 2 checks the "
                         "canonical digests match (default 2)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the plan's seed")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the full campaign document here")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-scenario progress lines")
    ap.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                    help="where fleet scenarios' workers run (default "
                         "gpu); the stub scenarios use no device")
    args = ap.parse_args(argv)

    chaos = _load_chaos()
    plan = chaos.load_plan(args.plan)
    if args.seed is not None:
        plan["seed"] = int(args.seed)
    log = (lambda m: None) if args.quiet else print
    doc = chaos.run_campaign(plan, repeat=args.repeat, log=log,
                             platform=args.platform)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")

    print(f"plan={doc['plan']} seed={doc['seed']} "
          f"scenarios={len(doc['scenarios'])} "
          f"passes={doc['determinism']['passes']}")
    for r in doc["scenarios"]:
        inv = r["invariants"]
        held = sum(1 for v in inv.values() if v)
        mt = r["metrics"]
        extras = " ".join(
            f"{k}={mt[k]}" for k in ("mttr_s", "reaction_s",
                                     "requeued", "tokens_lost")
            if mt.get(k) is not None)
        print(f"  {r['name']:<22} invariants {held}/{len(inv)} "
              f"wall={r['wall_s']}s {extras}")
    print(f"deterministic={doc['determinism']['reproducible']} "
          f"digest={doc['determinism']['digests'][0][:16]}")
    if doc["problems"]:
        for p in doc["problems"]:
            print(f"VIOLATED: {p}", file=sys.stderr)
        return 1
    print("all invariants held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
