#!/usr/bin/env python
"""Generated mutation sweep over the contract-bearing modules.

The reference runs ``cargo-mutants`` weekly over its contract-bearing
kernels (``/root/reference/.github/workflows/mutants.yml:30-35``) to
measure whether the differential/property oracles would catch injected
bugs. ``mutation_check.py`` keeps a *curated* 18-mutant list (proves the
harness works); this script is the generative analog (proves the suite is
mutation-hard): it enumerates every applicable single-node AST mutation —
arithmetic-operator swaps, comparison flips, boolean-operator swaps,
bitwise-invert drops, numeric-constant perturbations — across ``ops/``,
``kernels/``, ``utils/order.py``, ``batch.py``, ``prune.py`` and
``segmented.py``, applies a deterministic sample (or all of them), runs
the module's mapped test files per mutant in a fresh subprocess, and
reports the kill rate. Survivors are listed for triage and written to
``MUTATION_REPORT.md``.

Usage:
    python scripts/mutation_sweep.py --sample 40        # CI default
    python scripts/mutation_sweep.py --list             # count sites
    python scripts/mutation_sweep.py --all --threshold 0.9
"""

from __future__ import annotations

import argparse
import ast
import copy
import random
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# module -> test files that must kill its mutants (kept tight so a
# per-mutant run stays ~30-60 s).
# Every module's mutant run includes tests/test_mutation_hardening.py —
# that file is WHERE sweep-survivor killers land, so omitting it for a
# module silently disarms its killers (a seed-0 maxsim_kernel survivor
# stayed "alive" for exactly that reason).
TARGETS: dict[str, tuple[str, ...]] = {
    "innr_tpu/ops/dense.py": ("tests/test_dense.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/dense_f64.py": ("tests/test_dense_f64.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/binary.py": ("tests/test_binary.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/ternary.py": ("tests/test_ternary.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/scalar.py": ("tests/test_scalar.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/quant.py": ("tests/test_quant_fastmath.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/slot.py": ("tests/test_slot.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/sparse.py": ("tests/test_sparse.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/sparse_ext.py": ("tests/test_sparse.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/maxsim.py": ("tests/test_maxsim.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/topk.py": ("tests/test_topk.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/ops/fast_math.py": ("tests/test_quant_fastmath.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/utils/order.py": ("tests/test_topk.py", "tests/test_kernels.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/kernels/triton_knn.py": ("tests/test_kernels.py", "tests/test_prune.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/scan.py": ("tests/test_kernels.py", "tests/test_batch.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/route.py": ("tests/test_route.py", "tests/test_dispatch_coverage.py"),
    "innr_tpu/prune.py": ("tests/test_prune.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/batch.py": ("tests/test_batch.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/segmented.py": ("tests/test_segmented.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/pipeline.py": ("tests/test_pipeline_io.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/serving.py": (
        "tests/test_serving.py", "tests/test_mutation_hardening.py",
    ),
    # The distribution layer: every module's mutants must be observable
    # through the 8-virtual-device mesh suite (test_sharded covers the
    # whole parallel/ family; multihost has its own 2-process smoke).
    # test_mutation_hardening.py is REQUIRED here too — the sharded /
    # hierarchical / local-scan / grid / query-parallel sweep killers all
    # live there (TestShardedDispatchContracts and friends); omitting it
    # disarmed them for a while (round-4 fix).
    "innr_tpu/parallel/_scan.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/_stream.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/sharded.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/hierarchical.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/grid.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/query_parallel.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/sharded_maxsim.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/sharded_packed.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/sharded_pipeline.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/sharded_quant.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/sharded_slot.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/sharded_sparse.py": ("tests/test_sharded.py", "tests/test_mutation_hardening.py"),
    "innr_tpu/parallel/multihost.py": ("tests/test_multihost.py",),
    # Round-4 additions: every remaining non-__init__ module, so "all
    # modules swept" is literal. ops/reference.py is the force-reference
    # path AND the differential oracle — mutants must die in the parity
    # suites from either side of the comparison.
    "innr_tpu/ops/reference.py": (
        "tests/test_dense.py", "tests/test_dense_f64.py",
        "tests/test_quant_fastmath.py", "tests/test_slot.py",
        "tests/test_maxsim.py", "tests/test_sparse.py",
        "tests/test_mutation_hardening.py",
    ),
    "innr_tpu/distance.py": (
        "tests/test_distance_backend.py", "tests/test_interop_sklearn.py",
    ),
    "innr_tpu/backend.py": (
        "tests/test_distance_backend.py", "tests/test_dispatch_coverage.py",
    ),
    "innr_tpu/io.py": ("tests/test_pipeline_io.py",),
    "innr_tpu/config.py": (
        # test_distance_backend carries the matmul-precision and
        # force-reference knob killers — omitting it disarmed them
        # (the config.py:96 Eq survivor, round-5 sweep).
        "tests/test_dispatch_coverage.py", "tests/test_dense.py",
        "tests/test_distance_backend.py",
        "tests/test_mutation_hardening.py",
    ),
    "innr_tpu/loader.py": (
        "tests/test_native_loader.py", "tests/test_mutation_hardening.py",
    ),
    "innr_tpu/_native.py": (
        "tests/test_native_loader.py", "tests/test_topk.py",
        "tests/test_mutation_hardening.py",
    ),
    "innr_tpu/utils/padding.py": (
        "tests/test_kernels.py", "tests/test_binary.py",
    ),
    "innr_tpu/utils/asserts.py": (
        "tests/test_dense.py", "tests/test_batch.py",
    ),
    # Round-5 addition: the IVF aligned-layout index (masked summary +
    # padded scatter + metric dispatch all live here).
    "innr_tpu/ivf.py": (
        "tests/test_ivf.py", "tests/test_mutation_hardening.py",
    ),
}

_BINOP_SWAPS = {
    ast.Mult: ast.Add,
    ast.Add: ast.Sub,
    ast.Sub: ast.Add,
    ast.Div: ast.Mult,
    ast.FloorDiv: ast.Mult,
    ast.BitXor: ast.BitAnd,
    ast.BitAnd: ast.BitOr,
    ast.BitOr: ast.BitAnd,
    ast.LShift: ast.RShift,
    ast.RShift: ast.LShift,
}
_CMP_SWAPS = {
    ast.Lt: ast.LtE,
    ast.LtE: ast.Lt,
    ast.Gt: ast.GtE,
    ast.GtE: ast.Gt,
    ast.Eq: ast.NotEq,
    ast.NotEq: ast.Eq,
}

# Functions whose mutants are EQUIVALENT by design (pure performance
# knobs: block-size heuristics, thread-count choice). Any legal value
# yields correct results — only throughput changes — so mutating them
# measures nothing. The cargo-mutants `exclude_re` analog.
EXCLUDED_FUNCS = {
    "_pick_tile",
    "block_rows",
    "default_tile_n",
    "suggest_tile_n",
    "_pad_tail",
    "_pow2_ceil",
    "_n_threads",
    "memory_bytes",
}

# Module-level constants that are pure perf/bucketing knobs — plus
# _SPLITTER, whose float mutation (negation) is EQUIVALENT: Dekker's
# 2^12 + 1 splitter is sign-symmetric (verified: ±4097 both yield a
# valid 12-bit split). Its MAGNITUDE is pinned by
# test_df64_splitter_carries_low_bits. TOPK_CHUNK and the route bounds
# only move work between exact implementations.
EXCLUDED_CONSTS = {
    "_SPLITTER", "TOPK_CHUNK", "SUB_N", "_D_CHUNK_MAX",
    "TRITON_MIN_ROWS", "TRITON_MAX_Q",
}


def _excluded_ranges(tree: ast.AST) -> list[tuple[int, int]]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            node.name in EXCLUDED_FUNCS
        ):
            out.append((node.lineno, node.end_lineno or node.lineno))
        elif isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id in EXCLUDED_CONSTS
            for t in node.targets
        ):
            out.append((node.lineno, node.end_lineno or node.lineno))
        elif isinstance(node, ast.AnnAssign) and (
            isinstance(node.target, ast.Name)
            and node.target.id in EXCLUDED_CONSTS
        ):
            # `NAME: type = const` form.
            out.append((node.lineno, node.end_lineno or node.lineno))
    return out


def _annotation_nodes(tree: ast.AST) -> set[int]:
    """ids of nodes whose mutation measures nothing: type annotations
    (no-ops at runtime) and keyword-argument DEFAULT constants (caller-
    overridable tuning knobs — n_iters/n_clusters/seed-style parameters
    whose every legal value is correct; logic that *consumes* them stays
    mutable)."""
    out: set[int] = set()

    def mark(sub):
        if sub is None:
            return
        for n in ast.walk(sub):
            out.add(id(n))

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mark(node.returns)
            for a in (
                node.args.args + node.args.posonlyargs + node.args.kwonlyargs
            ):
                mark(a.annotation)
            if node.args.vararg:
                mark(node.args.vararg.annotation)
            if node.args.kwarg:
                mark(node.args.kwarg.annotation)
            for d in node.args.defaults:
                mark(d)
            for d in node.args.kw_defaults:
                mark(d)
        elif isinstance(node, ast.AnnAssign):
            mark(node.annotation)
    return out


@dataclass(frozen=True)
class Site:
    path: str
    index: int  # enumeration index within the module walk
    kind: str
    lineno: int
    descr: str


def _sites_in(tree: ast.AST) -> list[tuple[str, ast.AST, str]]:
    """Enumerate mutable nodes in a deterministic walk order, skipping
    excluded (perf-knob) function bodies."""
    excl = _excluded_ranges(tree)
    ann = _annotation_nodes(tree)

    def _is_excluded(node) -> bool:
        if id(node) in ann:
            return True
        ln = getattr(node, "lineno", None)
        return ln is not None and any(a <= ln <= b for a, b in excl)

    out = []
    for node in ast.walk(tree):
        if _is_excluded(node):
            continue
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOP_SWAPS:
            out.append(("binop", node, type(node.op).__name__))
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 and type(
            node.ops[0]
        ) in _CMP_SWAPS:
            out.append(("cmp", node, type(node.ops[0]).__name__))
        elif isinstance(node, ast.BoolOp):
            out.append(("boolop", node, type(node.op).__name__))
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            out.append(("invert", node, "Invert"))
        elif (
            isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))
            and not isinstance(node.value, bool)
            and node.value not in (0, 1)  # shape/axis literals dominate
        ):
            out.append(("const", node, repr(node.value)))
    return out


def _mutate(tree: ast.AST, index: int) -> ast.AST:
    """Apply the index-th site mutation to a (deep-copied) tree."""
    tree = copy.deepcopy(tree)
    kind, node, _ = _sites_in(tree)[index]
    if kind == "binop":
        node.op = _BINOP_SWAPS[type(node.op)]()
    elif kind == "cmp":
        node.ops = [_CMP_SWAPS[type(node.ops[0])]()]
    elif kind == "boolop":
        node.op = ast.Or() if isinstance(node.op, ast.And) else ast.And()
    elif kind == "invert":
        # drop the ~ entirely (the key-flip class of bug)
        node.op = ast.UAdd()
    elif kind == "const":
        node.value = node.value + 1 if isinstance(node.value, int) else -node.value
    return tree


def enumerate_sites() -> list[Site]:
    sites: list[Site] = []
    for path in sorted(TARGETS):
        src = (REPO / path).read_text()
        tree = ast.parse(src)
        for i, (kind, node, descr) in enumerate(_sites_in(tree)):
            sites.append(Site(path, i, kind, getattr(node, "lineno", 0), descr))
    return sites


def run_site(site: Site, timeout: int = 1200) -> str:
    src_path = REPO / site.path
    original = src_path.read_text()
    tree = ast.parse(original)
    mutated = ast.unparse(ast.fix_missing_locations(_mutate(tree, site.index)))
    src_path.write_text(mutated)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-x", "-q",
             "-p", "no:cacheprovider", *TARGETS[site.path]],
            cwd=REPO, capture_output=True, text=True, timeout=timeout,
        )
        return "KILLED" if proc.returncode != 0 else "SURVIVED"
    except subprocess.TimeoutExpired:
        return "TIMEOUT"  # counts as killed: the mutant broke the suite
    finally:
        src_path.write_text(original)


def main() -> int:
    # A SIGTERM (e.g. an outer `timeout` expiring) must still run
    # run_site's finally-restore, or a half-tested MUTANT stays on disk
    # masquerading as source. Convert it to SystemExit so finally blocks
    # execute. (This bit a timeout-killed run: segmented.py was left
    # mutated and only a git-status check caught it.)
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))

    ap = argparse.ArgumentParser()
    ap.add_argument("--sample", type=int, default=40,
                    help="deterministic sample size (0 = all sites)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--threshold", type=float, default=0.9)
    ap.add_argument("--report", default="MUTATION_REPORT.md")
    ap.add_argument("--modules", default="",
                    help="comma-separated substrings; keep only sites whose "
                         "path matches one (e.g. 'order,topk,dense.py' for "
                         "an exhaustive run over the foundational modules)")
    args = ap.parse_args()

    sites = enumerate_sites()
    if args.modules:
        pats = [p.strip() for p in args.modules.split(",") if p.strip()]
        sites = [s for s in sites if any(p in s.path for p in pats)]
    if args.list:
        by_mod: dict[str, int] = {}
        for s in sites:
            by_mod[s.path] = by_mod.get(s.path, 0) + 1
        for path, cnt in sorted(by_mod.items()):
            print(f"{cnt:5d}  {path}")
        print(f"{len(sites):5d}  TOTAL mutable sites")
        return 0

    chosen = sites
    if not args.all and args.sample and args.sample < len(sites):
        chosen = random.Random(args.seed).sample(sites, args.sample)

    killed, survivors = 0, []
    t0 = time.time()
    for i, s in enumerate(chosen):
        verdict = run_site(s)
        ok = verdict in ("KILLED", "TIMEOUT")
        killed += ok
        tag = f"{s.path}:{s.lineno} [{s.kind} {s.descr}]"
        print(f"[{i + 1}/{len(chosen)}] {verdict:9s} {tag}", flush=True)
        if not ok:
            survivors.append(tag)
    rate = killed / max(len(chosen), 1)
    dt = time.time() - t0

    lines = [
        "# Mutation sweep report",
        "",
        f"- sites enumerated: {len(sites)} across {len(TARGETS)} modules",
        f"- mutants run: {len(chosen)} (seed {args.seed})",
        f"- kill rate: **{rate:.1%}** in {dt / 60:.1f} min",
        "",
        "## Survivors (triage)",
        "",
    ]
    lines += [f"- `{t}`" for t in survivors] or ["- none"]
    (REPO / args.report).write_text("\n".join(lines) + "\n")
    print(f"\nkill rate {rate:.1%} ({killed}/{len(chosen)}); "
          f"report -> {args.report}")
    return 0 if rate >= args.threshold else 1


if __name__ == "__main__":
    sys.exit(main())
