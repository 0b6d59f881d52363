"""Time the encoder's two per-row table operations on the default device,
each in two forms, at the shapes the encoder uses for a 1 MiB shard
(32 rows of 32768 positions; the 286-symbol litlen and 30-symbol distance
alphabets):

  lookup     out[m, l] = tab[m, sym[m, l]]   one-hot f32 dot (HIGHEST)
                                             vs integer gather
  histogram  counts[m, c] = #{l: sym[m,l]==c} int8 one-hot dot
                                             vs flat bincount

Each form is first checked for exact equality with a numpy reference, then
timed (see `timed`). Prints one line per form and the card's name and power
limit.

    python tools/time_table_forms.py
"""
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from deflate_compression_tpu.core import huffman  # noqa: E402

M, L = 32, 32768
REPS = 100


def lookup_onehot_dot(sym, tab):
    Cn = tab.shape[1]
    cls = jnp.arange(Cn, dtype=jnp.int32)
    oh = (sym[:, :, None] == cls[None, None, :]).astype(jnp.float32)
    out = jax.lax.dot_general(oh, tab.astype(jnp.float32)[:, :, None],
                              (((2,), (1,)), ((0,), (0,))),
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)
    return out[:, :, 0].astype(jnp.uint32)


def histogram_bincount(sym, num_classes):
    Mr = sym.shape[0]
    s = jnp.where((sym >= 0) & (sym < num_classes), sym, num_classes)
    key = jnp.arange(Mr, dtype=jnp.int32)[:, None] * (num_classes + 1) + s
    cnt = jnp.bincount(key.reshape(-1), length=Mr * (num_classes + 1))
    return cnt.reshape(Mr, num_classes + 1)[:, :num_classes].astype(jnp.int32)


def symbols(rng, n_cls):
    """Text-like skew: 70% of positions hit 20 hot symbols, 20% masked."""
    hot = rng.choice(n_cls, 20, replace=False)
    s = np.where(rng.random((M, L)) < 0.7, hot[rng.integers(0, 20, (M, L))],
                 rng.integers(0, n_cls, (M, L)))
    return np.where(rng.random((M, L)) < 0.2, n_cls, s).astype(np.int32)


def timed(fn, *args):
    """Per-call device time: REPS calls queued back to back (JAX dispatches
    asynchronously), ended by one block_until_ready; median of 5 batches."""
    f = jax.jit(fn, static_argnums=tuple(
        i for i, a in enumerate(args) if isinstance(a, int)))
    out = f(*args)
    out.block_until_ready()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(REPS):
            r = f(*args)
        r.block_until_ready()
        ts.append((time.perf_counter() - t0) / REPS)
    return np.asarray(out), 1e3 * float(np.median(ts))


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; found {dev.platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# device: {dev.device_kind} | {smi}")
    rng = np.random.default_rng(0)
    for n_cls in (286, 30):
        sym = symbols(rng, n_cls)
        tab = rng.integers(0, 1 << 20, (M, n_cls)).astype(np.uint32)
        tab[:, 0] = (1 << 20) - 1
        want_lk = np.where(sym < n_cls,
                           np.take_along_axis(tab, np.minimum(sym, n_cls - 1),
                                              axis=1), 0)
        want_h = np.stack([np.bincount(r[r < n_cls], minlength=n_cls)
                           for r in sym])
        s, t = jnp.asarray(sym), jnp.asarray(tab)
        for name, fn, args, want in (
                ("lookup onehot_dot", lookup_onehot_dot, (s, t),
                 want_lk),
                ("lookup gather", huffman.rows_lookup, (s, t), want_lk),
                ("histogram int8_dot", huffman.histogram_rows_matmul,
                 (s, n_cls), want_h),
                ("histogram bincount", histogram_bincount, (s, n_cls),
                 want_h)):
            got, ms = timed(fn, *args)
            exact = bool(np.array_equal(got.astype(np.int64),
                                        want.astype(np.int64)))
            print(f"{name:20s} C={n_cls:3d} exact={exact} "
                  f"median_ms={ms:.4f}")


if __name__ == "__main__":
    main()
