#!/usr/bin/env python
"""Run every example as an assertion suite — the analog of the reference CI
executing 4 examples as correctness checks (ci.yml:63-68). Each example
asserts its own invariants; any failure propagates."""

import pathlib
import runpy
import sys
import time

# Invoked as `python examples/run_all.py`, sys.path[0] is examples/, not
# the repo root — make the runner self-sufficient instead of relying on
# an editable install being present.
_ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

EXAMPLES = [
    "01_basic_ops",
    "batch_demo",
    "binary_demo",
    "binary_vs_rabitq",
    "ternary_demo",
    "matryoshka_search",
    "maxsim_colbert",
    "fast_math_demo",
    "minhash_dedup",
    "sparse_retrieval",
    "sharded_search",
    "two_stage_pipeline",
    "serving_demo",
    "pruned_scan_demo",
]


def main():
    from innr_tpu import compile_cache

    compile_cache.enable()
    here = pathlib.Path(__file__).parent
    failures = []
    for name in EXAMPLES:
        print(f"=== {name} " + "=" * max(0, 50 - len(name)), flush=True)
        t0 = time.perf_counter()
        try:
            runpy.run_path(str(here / f"{name}.py"), run_name="__main__")
            print(f"--- {name} ok ({time.perf_counter() - t0:.1f}s)\n", flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue
            failures.append((name, e))
            print(f"--- {name} FAILED: {e}\n", flush=True)
    if failures:
        print(f"{len(failures)} example(s) failed: {[n for n, _ in failures]}")
        sys.exit(1)
    print(f"all {len(EXAMPLES)} examples passed")


if __name__ == "__main__":
    main()
