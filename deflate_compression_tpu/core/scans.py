"""Blocked prefix scans for long 1-D arrays.

`jax.lax.cummax`/`cumsum` on a length-S axis lower to ~log2(S) full-array
passes (21 passes at S = 2 M). The blocked two-level form does the same
scan in log2(R) passes over the full array plus a scan over the S/R row
maxima: with R = 64 that is 6 full-size passes instead of 21 (the scans
were once the dominant fixed cost of the decoder's phase C; not yet
re-measured on the GPU).

Only 1-D operands (the codec's hot case). Semantics identical to the jax
primitives; cross-checked against them in tests/test_bits.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_R = 64


def _blocked(x: jnp.ndarray, cum, combine, neutral):
    S = x.shape[0]
    if S % _R or S <= _R:
        return cum(x)
    rows = x.reshape(S // _R, _R)
    within = cum(rows, axis=1)
    carry = cum(within[:, -1])
    prev = jnp.concatenate(
        [jnp.full((1,), neutral, x.dtype), carry[:-1]])
    return combine(within, prev[:, None]).reshape(S)


def cummax(x: jnp.ndarray) -> jnp.ndarray:
    info = jnp.iinfo(x.dtype)
    return _blocked(x, jax.lax.cummax, jnp.maximum, info.min)


def cummin(x: jnp.ndarray) -> jnp.ndarray:
    info = jnp.iinfo(x.dtype)
    return _blocked(x, jax.lax.cummin, jnp.minimum, info.max)


def cumsum(x: jnp.ndarray) -> jnp.ndarray:
    return _blocked(x, jnp.cumsum, lambda a, b: a + b, np.int64(0))


def cummax_rows(x: jnp.ndarray) -> jnp.ndarray:
    """Row-wise cummax of a 2-D array along axis 1 (each row independent),
    same blocked two-level structure as the 1-D scans."""
    B, S = x.shape
    if S % _R or S <= _R:
        return jax.lax.cummax(x, axis=1)
    info = jnp.iinfo(x.dtype)
    rows = x.reshape(B, S // _R, _R)
    within = jax.lax.cummax(rows, axis=2)
    carry = jax.lax.cummax(within[:, :, -1], axis=1)
    prev = jnp.concatenate(
        [jnp.full((B, 1), info.min, x.dtype), carry[:, :-1]], axis=1)
    return jnp.maximum(within, prev[:, :, None]).reshape(B, S)
