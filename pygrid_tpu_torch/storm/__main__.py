"""``python -m pygrid_tpu_torch.storm`` — run a storm from the command line.

Exit status 0 when every reaction verdict passed (and, for ``--replay``,
the verdicts matched the recorded run); 1 otherwise. The reference pins
its storms to the CPU (its ``scripts/gridstorm.sh``); the port runs a
storm where its nodes run, on the card: ``--device`` defaults to
``cuda`` and raises without a GPU, and ``--device cpu`` runs it on the
host.
"""

from __future__ import annotations

import argparse
import json
import sys


def _print_report(report, as_json: bool) -> None:
    if as_json:
        print(
            json.dumps(
                {
                    "scenario": report.scenario["name"],
                    "ok": report.ok,
                    "verdicts": [
                        {
                            "name": v.name,
                            "ok": v.ok,
                            "detail": v.detail,
                            "measured": v.measured,
                        }
                        for v in report.verdicts
                    ],
                    "metrics": report.metrics,
                    "dump": report.dump_path,
                },
                indent=1,
                default=repr,
            )
        )
        return
    print(f"storm scenario: {report.scenario['name']}")
    for leg, counts in sorted(report.metrics.get("ops", {}).items()):
        summary = ", ".join(
            f"{k}={v}" for k, v in sorted(counts.items())
        )
        print(f"  traffic {leg:12s} {summary}")
    for v in report.verdicts:
        mark = "PASS" if v.ok else "FAIL"
        extra = f"  ({v.detail})" if v.detail and not v.ok else ""
        print(f"  verdict {v.name:22s} {mark}{extra}")
    if report.dump_path:
        print(f"  dump: {report.dump_path}")
    print("storm:", "PASS" if report.ok else "FAIL")


def main(argv=None) -> int:
    from pygrid_tpu_torch.storm.scenarios import (
        StormScenario,
        builtin_scenarios,
        get_scenario,
    )

    parser = argparse.ArgumentParser(
        prog="python -m pygrid_tpu_torch.storm",
        description=(
            "open-loop load + fault-injection storms against an "
            "in-process grid of port nodes"
        ),
    )
    parser.add_argument(
        "--scenario", default="smoke",
        help="built-in scenario name (see --list)",
    )
    parser.add_argument(
        "--spec", help="path to a YAML/JSON scenario spec (overrides "
        "--scenario)",
    )
    parser.add_argument(
        "--replay", metavar="DUMP",
        help="re-run the scenario recorded in a storm flight dump and "
        "compare verdicts",
    )
    parser.add_argument(
        "--list", action="store_true", help="list built-in scenarios"
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable report"
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the nodes hold their tensors (default cuda; cpu on a "
        "host without a GPU)",
    )
    args = parser.parse_args(argv)

    if args.list:
        for name, doc in sorted(builtin_scenarios().items()):
            print(f"{name:10s} {doc}")
        return 0

    if args.replay:
        from pygrid_tpu_torch.storm.replay import replay

        report, mismatches = replay(args.replay, device=args.device)
        _print_report(report, args.json)
        if mismatches:
            print(f"replay verdict mismatches: {mismatches}")
            return 1
        return 0 if report.ok else 1

    from pygrid_tpu_torch.storm.loadgen import StormHarness

    if args.spec:
        with open(args.spec, encoding="utf-8") as fh:
            scenario = StormScenario.from_yaml(fh.read())
    else:
        scenario = get_scenario(args.scenario)
    report = StormHarness(scenario, device=args.device).run()
    _print_report(report, args.json)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
