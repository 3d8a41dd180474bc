"""Contract checks.

The reference crate's dispatching functions *panic* on length mismatch
(reference ``src/lib.rs:34-46``). The analog here raises :class:`ContractError`
(a ``ValueError``) at trace time — shapes are static under ``jax.jit``, so the
check costs nothing at runtime and fires exactly where the panic would.
"""

from __future__ import annotations


class ContractError(ValueError):
    """Raised when an input violates a documented API contract.

    Equivalent to the reference crate's contract panics
    (e.g. ``innr::dot: slice length mismatch``).
    """


def check_same_length(a, b, op: str) -> None:
    """Raise unless the trailing dimensions of ``a`` and ``b`` match.

    Mirrors the reference's length-mismatch panic in dispatching functions
    (reference ``src/dense.rs:56-63``).
    """
    if a.shape[-1] != b.shape[-1]:
        raise ContractError(
            f"innr_tpu::{op}: length mismatch ({a.shape[-1]} vs {b.shape[-1]})"
        )


def check_rank(x, rank: int, op: str, name: str = "input") -> None:
    """Raise unless ``x`` has exactly ``rank`` dimensions."""
    if x.ndim != rank:
        raise ContractError(
            f"innr_tpu::{op}: {name} must be rank-{rank}, got rank-{x.ndim} "
            f"shape {x.shape}"
        )
