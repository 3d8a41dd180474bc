"""Pins for scripts/plot_benchmarks.py --check / --update semantics.

Round-5 regression: the original check() matched pin names (not
bench_keys) against bench stderr names; the two sets were disjoint, so
--check printed nothing and returned 0 for ANY regression — a silent
no-op guarding the whole pinned perf record. These tests pin the fixed
contract: keyed by bench_key, missing keys fail, rooflines compare with
per-config tolerance, lower_is_better inverts the value comparison, and
--update rewrites values mechanically.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _load_module():
    spec = importlib.util.spec_from_file_location(
        "plot_benchmarks", REPO / "scripts" / "plot_benchmarks.py"
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["plot_benchmarks"] = mod
    spec.loader.exec_module(mod)
    return mod


PB = _load_module()


def _data(**configs):
    return {"hardware": "x", "recorded": "never", "configs": configs}


class TestParse:
    def test_parses_value_and_roofline(self):
        seen = PB.parse_stderr(
            "# a_key: 1,234.5 roofline=0.93\n# b_key: 42\n"
        )
        assert seen["a_key"] == (1234.5, 0.93)
        assert seen["b_key"] == (42.0, None)


class TestCheck:
    def test_missing_bench_key_fails(self):
        data = _data(cfg={"bench_key": "nope", "value": 1.0})
        assert PB.check(data, "# other: 1.0\n", 0.10) == 1

    def test_roofline_regression_fails(self):
        data = _data(
            cfg={"bench_key": "k", "value": 1.0, "roofline_fraction": 0.9}
        )
        assert PB.check(data, "# k: 1.0 roofline=0.70\n", 0.10) == 1
        assert PB.check(data, "# k: 1.0 roofline=0.85\n", 0.10) == 0

    def test_null_bench_key_is_exempt(self):
        data = _data(
            cfg={"bench_key": None, "source": "elsewhere", "value": 5.0}
        )
        assert PB.check(data, "", 0.10) == 0

    def test_value_check_when_no_roofline(self):
        data = _data(cfg={"bench_key": "k", "value": 100.0})
        # 2x tolerance on raw values (run-to-run variance)
        assert PB.check(data, "# k: 85.0\n", 0.10) == 0
        assert PB.check(data, "# k: 75.0\n", 0.10) == 1

    def test_lower_is_better_inverts(self):
        data = _data(
            cfg={"bench_key": "k", "value": 1.0, "lower_is_better": True}
        )
        assert PB.check(data, "# k: 0.5\n", 0.10) == 0
        assert PB.check(data, "# k: 1.5\n", 0.10) == 1

    def test_per_config_tolerance_overrides(self):
        data = _data(
            cfg={
                "bench_key": "k",
                "value": 1.0,
                "tolerance": 0.025,
            }
        )
        # 5% value floor under the tight per-config tolerance
        assert PB.check(data, "# k: 0.96\n", 0.10) == 0
        assert PB.check(data, "# k: 0.90\n", 0.10) == 1

    def test_real_medians_all_keys_present_in_synthetic_run(
            self, tmp_path, monkeypatch):
        # Every bench_key'd pin must fail against an EMPTY stderr — i.e.
        # the protected surface is non-empty and cannot silently shrink.
        # A synthetic medians file stands in for the pinned one (none is
        # pinned until the benchmark's first card run).
        pins = {f"cfg{i}": {"bench_key": f"k{i}", "value": float(i + 1),
                            "roofline_fraction": 0.5} for i in range(15)}
        pins["ext"] = {"bench_key": None, "value": 7.0}
        medians = tmp_path / "medians.json"
        medians.write_text(json.dumps(_data(**pins)))
        monkeypatch.setattr(PB, "MEDIANS", medians)
        data = PB.load()
        keyed = [
            n for n, c in data["configs"].items() if c.get("bench_key")
        ]
        assert len(keyed) >= 15
        assert PB.check(data, "", 0.10) == 1
        full = "".join(f"# k{i}: {i + 1}.0 roofline=0.5\n" for i in range(15))
        assert PB.check(data, full, 0.10) == 0


class TestUpdate:
    def test_update_rewrites_pins(self, tmp_path, monkeypatch):
        medians = tmp_path / "medians.json"
        medians.write_text(
            json.dumps(
                _data(
                    cfg={
                        "bench_key": "k",
                        "value": 1.0,
                        "roofline_fraction": 0.5,
                    },
                    ext={"bench_key": None, "value": 7.0},
                )
            )
        )
        monkeypatch.setattr(PB, "MEDIANS", medians)
        data = json.loads(medians.read_text())
        rc = PB.update(data, "# k: 2,000.0 roofline=0.95\n")
        assert rc == 0
        got = json.loads(medians.read_text())
        assert got["configs"]["cfg"]["value"] == 2000.0
        assert got["configs"]["cfg"]["roofline_fraction"] == 0.95
        assert got["configs"]["ext"]["value"] == 7.0  # untouched
        assert got["recorded"] != "never"
