#!/usr/bin/env python
"""Render the pinned benchmark medians (benches/medians.json).

The analog of the reference's ``scripts/plot_benchmarks.py:13-19``, which
pins criterion medians in-repo as the README chart source so performance
regressions diff mechanically. Here the pinned data is
``benches/medians.json``, written by ``--update`` from a bench run (no
pins exist until the benchmark's first run on the card); this script
renders it as

- a markdown table (stdout; paste into README/PERF.md), and
- ``docs/bench_roofline.png`` — a horizontal bar chart of roofline
  fractions (the run-variance-proof metric) with ``--png``.

Compare a fresh run against the pins with ``--check`` (exit 1 when any
roofline fraction regresses by more than ``--tolerance``, default 0.10):
feed it the ``# name: value roofline=F`` stderr lines of
``python bench.py --full``.

Each pinned config carries a ``bench_key`` — the exact stderr name
``bench.py --full`` prints for it (round-5 fix: the pin names themselves
never matched the stderr names, so --check was a silent no-op that
passed any regression). Configs measured OUTSIDE bench.py (serving QPS,
envelope rows) pin ``"bench_key": null`` plus a ``source`` naming the
script that measures them; --check ignores those. A config whose
bench_key is MISSING from the stderr file is a failure, not a skip.

``--update`` ingests the same stderr file and rewrites the pinned
value + roofline for every matched config (and stamps ``recorded``),
so refreshing the record is mechanical.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
MEDIANS = REPO / "benches" / "medians.json"


def load():
    return json.loads(MEDIANS.read_text())


def render_table(data) -> str:
    lines = [
        f"Pinned medians — {data['hardware']} (recorded {data['recorded']})",
        "",
        "| config | value | unit | roofline |",
        "|---|---|---|---|",
    ]
    for name, c in data["configs"].items():
        rf = c.get("roofline_fraction")
        rf_s = f"{rf:.2f}" if isinstance(rf, (int, float)) else "—"
        v = c["value"]
        v_s = f"{v:,.4g}" if isinstance(v, float) and v < 1e4 else f"{v:,}"
        lines.append(f"| {name} | {v_s} | {c['unit']} | {rf_s} |")
    return "\n".join(lines)


def render_png(data, out: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = [
        (name, c["roofline_fraction"])
        for name, c in data["configs"].items()
        if isinstance(c.get("roofline_fraction"), (int, float))
    ]
    rows.sort(key=lambda x: x[1])
    names = [n for n, _ in rows]
    fracs = [f for _, f in rows]
    fig, ax = plt.subplots(figsize=(9, 0.45 * len(rows) + 1.2))
    ax.barh(names, fracs, color="#4878a8")
    ax.axvline(1.0, color="#a84848", linestyle="--", linewidth=1,
               label="HBM read roofline")
    ax.set_xlabel("fraction of same-session HBM read bandwidth")
    ax.set_title("innr_tpu kernels vs the bandwidth roofline")
    ax.legend(loc="lower right")
    fig.tight_layout()
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")


def parse_stderr(bench_stderr: str) -> dict:
    """`# name: value roofline=F` lines -> {name: (value, roofline|None)}."""
    seen = {}
    for m in re.finditer(
        r"#\s*([\w./-]+):\s*([\d,.]+)(?:\s+roofline=([\d.]+))?", bench_stderr
    ):
        name, val, rf = m.groups()
        seen[name] = (
            float(val.replace(",", "")),
            float(rf) if rf is not None else None,
        )
    return seen


def check(data, bench_stderr: str, default_tolerance: float) -> int:
    """Compare bench stderr lines against the pins, keyed by bench_key.

    A pinned config with a bench_key that does NOT appear in the stderr
    file fails the check — a rename or a dropped stage must not silently
    shrink the protected surface.
    """
    seen = parse_stderr(bench_stderr)
    failures = 0
    for name, c in data["configs"].items():
        key = c.get("bench_key")
        if not key:
            continue  # measured by another script (see its "source")
        if key not in seen:
            print(f"MISSING {name}: bench stderr has no '{key}' line")
            failures += 1
            continue
        got_v, got_rf = seen[key]
        tolerance = c.get("tolerance", default_tolerance)
        pin_rf = c.get("roofline_fraction")
        if isinstance(pin_rf, (int, float)) and got_rf is not None:
            if got_rf < pin_rf - tolerance:
                print(
                    f"REGRESSION {name}: roofline {got_rf:.2f} < pin "
                    f"{pin_rf:.2f}"
                )
                failures += 1
                continue
            print(f"ok {name}: roofline {got_rf:.2f} (pin {pin_rf:.2f})")
        else:
            # No roofline on either side: compare raw values (run
            # variance makes this looser — 2x tolerance).
            pin_v = c["value"]
            if c.get("lower_is_better"):
                bad = got_v > pin_v * (1.0 + 2.0 * tolerance)
            else:
                bad = pin_v > 0 and got_v < pin_v * (1.0 - 2.0 * tolerance)
            if bad:
                print(
                    f"REGRESSION {name}: value {got_v:,.4g} vs pin "
                    f"{pin_v:,.4g} (tol {2 * tolerance:.0%})"
                )
                failures += 1
                continue
            print(f"ok {name}: value {got_v:,.4g} (pin {pin_v:,.4g})")
    return 1 if failures else 0


def update(data, bench_stderr: str) -> int:
    """Rewrite pins from a fresh bench stderr file (mechanical refresh)."""
    import datetime

    seen = parse_stderr(bench_stderr)
    updated = 0
    for name, c in data["configs"].items():
        key = c.get("bench_key")
        if not key or key not in seen:
            continue
        got_v, got_rf = seen[key]
        c["value"] = got_v
        if got_rf is not None:
            c["roofline_fraction"] = got_rf
        updated += 1
    data["recorded"] = datetime.date.today().isoformat()
    MEDIANS.write_text(json.dumps(data, indent=2) + "\n")
    print(f"updated {updated}/{len(data['configs'])} pins -> {MEDIANS}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--png", action="store_true")
    ap.add_argument("--check", metavar="BENCH_STDERR_FILE")
    ap.add_argument("--update", metavar="BENCH_STDERR_FILE")
    ap.add_argument("--tolerance", type=float, default=0.10)
    args = ap.parse_args()
    data = load()
    if args.check:
        return check(data, Path(args.check).read_text(), args.tolerance)
    if args.update:
        return update(data, Path(args.update).read_text())
    print(render_table(data))
    if args.png:
        render_png(data, REPO / "docs" / "bench_roofline.png")
    return 0


if __name__ == "__main__":
    return_code = main()
    sys.exit(return_code)
