"""Shared benchmark harness utilities: the CSV row contract of the JAX
package's ``benchmarks/common.py`` (only what the ported benches use)."""
from __future__ import annotations


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"
