"""Hierarchical SHIMMER reduction — vectorized window-argmin per read.

The reference slides a ring buffer of r minimizers per read and emits the
buffer's minimum-hash element per step, deduplicated against the previous
emission (src/shmr_reduce.c:53-90).  Its find_minimizer scans ring slots in
*array* order with a strict '<', so hash ties resolve to the lowest ring
slot (element offset mod r) — a quirk preserved here for output parity.

Vectorized form over per-read compacted arrays [B, C]: the window winner at
column j is selected by an r-step shift tournament on the composite key
(x with its span byte replaced by the ring slot); ties are impossible
because slots within one window are distinct.  Applied once for L1, twice
for L2 (src/shmr_index.c:199,216).  No gathers or scatters: r static
shifts + where-chains, then the log-shift compaction of ops.sketch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .sketch import INF, _shift_compact, _shift_right


def reduce_impl(x: jnp.ndarray, y: jnp.ndarray, count: jnp.ndarray, *, r: int):
    """Reduce per-read minimizer rows by factor ~r.

    Args:
      x, y:  [B, C] uint64 minimizer records compacted per row (INF padding).
      count: [B] int32 valid entries per row.
      r:     reduction window (static, < 256).

    Returns (x', y', count') in the same layout.
    """
    assert 0 < r < 256
    B, C = x.shape
    col = jnp.arange(C, dtype=jnp.uint64)[None, :]
    # composite key: hash in the high 56 bits, ring slot replaces the span byte
    key = (x & ~jnp.uint64(0xFF)) | (col % jnp.uint64(r))

    best_key, best_x, best_y = key, x, y
    for d in range(1, r):
        kd = _shift_right(key, d, INF)
        xd = _shift_right(x, d, INF)
        yd = _shift_right(y, d, INF)
        win = kd < best_key
        best_key = jnp.where(win, kd, best_key)
        best_x = jnp.where(win, xd, best_x)
        best_y = jnp.where(win, yd, best_y)

    cols = jnp.arange(C)[None, :]
    valid = (cols >= (r - 1)) & (cols < count[:, None])
    prev_y = _shift_right(best_y, 1, INF)
    prev_valid = jnp.pad(valid, ((0, 0), (1, 0)))[:, :C]
    emit = valid & ((best_y != prev_y) | ~prev_valid)

    ox = jnp.where(emit, best_x, INF)
    oy = jnp.where(emit, best_y, INF)
    (ox, oy), ocount = _shift_compact(emit, [ox, oy])
    return ox, oy, ocount


reduce_batch = jax.jit(reduce_impl, static_argnames=("r",))


def reduce_flat_np(x: np.ndarray, y: np.ndarray, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Host convenience: reduce a concatenated (rid-ordered) minimizer list.

    Splits by the rid field of y, pads to a batch, reduces on device, and
    re-flattens — matches the reference's concatenated-stream semantics
    because dedup never fires across rid boundaries (y embeds rid).
    """
    if len(x) == 0:
        return x.copy(), y.copy()
    rids = (y >> np.uint64(32)).astype(np.int64)
    boundaries = np.flatnonzero(np.diff(rids)) + 1
    segs = np.split(np.arange(len(x)), boundaries)
    C = max(len(s) for s in segs)
    B = len(segs)
    bx = np.full((B, C), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    by = np.full((B, C), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    cnt = np.zeros(B, np.int32)
    for i, s in enumerate(segs):
        bx[i, :len(s)] = x[s]
        by[i, :len(s)] = y[s]
        cnt[i] = len(s)
    ox, oy, oc = jax.device_get(
        reduce_batch(jnp.asarray(bx), jnp.asarray(by), jnp.asarray(cnt), r=r))
    xs = [ox[i, :oc[i]] for i in range(B)]
    ys = [oy[i, :oc[i]] for i in range(B)]
    return np.concatenate(xs), np.concatenate(ys)


def end_filter_np(x: np.ndarray, y: np.ndarray, read_lengths: np.ndarray,
                  end_length: int):
    """Split minimizers into 5'-end / 3'-end subsets by proximity to the
    read ends (reference mm_end_filter, src/shmr_end_filter.c:12-36 —
    dormant there: its call site is commented out at src/shmr_index.c:173,
    kept for inventory parity).

    Returns ((x5, y5), (x3, y3)): records with pos < end_length, and
    records with rlen - pos + span < end_length (a record near both ends
    of a short read appears in both, as in the reference).
    """
    rid = (y >> np.uint64(32)).astype(np.int64)
    span = (x & np.uint64(0xFF)).astype(np.int64)
    pos = ((y & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64) + 1
    rlen = read_lengths[rid].astype(np.int64)
    r_pos = rlen - pos + span
    m5 = pos < end_length
    m3 = r_pos < end_length
    return (x[m5], y[m5]), (x[m3], y[m3])
