"""Vectorized (w,k)-minimizer sketch — the device SHIMMER L0 kernel.

The reference computes minimizers with a sequential ring buffer per read
(src/mm_sketch.c:70-151).  Here the same *output* is produced by a data-
parallel reformulation over a padded batch of reads [B, L]:

1. per-position rolling k-mers via k shifted adds — computed on *raw*
   positions (no stream compaction needed: a k-mer is only defined when the
   run length l >= k, which guarantees its window contains no ambiguous
   base, so raw-position k-mers equal the reference's gap-skipping rolling
   registers wherever they are defined),
2. the minimizer stream (valid, non-strand-symmetric positions plus
   ambiguous-base placeholders) stably compacted WITHOUT sorts or
   scatters: log-shift bit passes over the per-entry shift distances
   (_shift_compact), which XLA fuses into elementwise passes,
3. window minima via sliding prefix/suffix extrema combined by static
   shifts (no gathers),
4. the emission set derived declaratively:  an entry e is emitted iff it is
   a minimum of some *complete* window (window-end run length
   l >= w+k-1), or it is the held minimum of the final window.

For k <= 16 (the pipeline default) k-mers and hashes are 32-bit, halving
the bytes every elementwise pass moves.

For sequences without ambiguous bases this emission set — ordered by
position — is exactly the reference's emission sequence (validated against
a transliterated oracle in tests/test_sketch.py).
Known divergences (both superset-only, order preserved; negligible for
k=16 real data, validated in tests/test_sketch.py):
  * with ambiguous bases mid-read the reference's emission guard is
    evaluated at a later loop step and can drop minima near the reset;
  * when hash ties occur exactly at a read's first complete window, the
    reference's supersede guard (l >= w+k) drops the held tie one step
    after the l == w+k-1 special case; the set semantics keep it.

Encodings (must match src/mm_sketch.c:62-68):
    x = hash64(canonical_kmer) << 8 | span        (span == k, non-HPC)
    y = rid << 32 | last_pos << 1 | strand
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF = jnp.uint64(0xFFFFFFFFFFFFFFFF)


def hash64(key: jnp.ndarray, mask) -> jnp.ndarray:
    """Invertible minimizer hash (reference: src/mm_sketch.c:23-32).

    Valid in any unsigned dtype whose width is a multiple of the mask
    width: every step is taken modulo a power of two that the lane width
    divides evenly.
    """
    one = jnp.asarray(1, key.dtype)
    key = (~key + (key << (21 * one))) & mask
    key = key ^ (key >> (24 * one))
    key = (key + (key << (3 * one)) + (key << (8 * one))) & mask
    key = key ^ (key >> (14 * one))
    key = (key + (key << (2 * one)) + (key << (4 * one))) & mask
    key = key ^ (key >> (28 * one))
    key = (key + (key << (31 * one))) & mask
    return key


def _shift_right(a: jnp.ndarray, n: int, fill) -> jnp.ndarray:
    """a[:, i-n] with fill for i < n (static shift, no gather)."""
    if n == 0:
        return a
    return jnp.pad(a[:, :-n], ((0, 0), (n, 0)), constant_values=fill)


def _shift_left(a: jnp.ndarray, n: int, fill) -> jnp.ndarray:
    if n == 0:
        return a
    return jnp.pad(a[:, n:], ((0, 0), (0, n)), constant_values=fill)


def _sliding_min_trailing(a: jnp.ndarray, w: int, fill) -> jnp.ndarray:
    """W[t] = min(a[t-w+1 .. t]); out-of-range entries = fill."""
    B, L = a.shape
    nb = -(-L // w)
    P = nb * w
    ap = jnp.pad(a, ((0, 0), (0, P - L)), constant_values=fill)
    blocks = ap.reshape(B, nb, w)
    pref = jax.lax.cummin(blocks, axis=2).reshape(B, P)
    suf = jax.lax.cummin(blocks, axis=2, reverse=True).reshape(B, P)
    left = _shift_right(suf, w - 1, fill)[:, :L]
    return jnp.minimum(left, pref[:, :L])


def _sliding_max_leading(a: jnp.ndarray, w: int, fill) -> jnp.ndarray:
    """M[t] = max(a[t .. t+w-1]); out-of-range entries = fill."""
    B, L = a.shape
    nb = -(-L // w)
    P = nb * w
    ap = jnp.pad(a, ((0, 0), (0, P - L)), constant_values=fill)
    blocks = ap.reshape(B, nb, w)
    pref = jax.lax.cummax(blocks, axis=2).reshape(B, P)
    suf = jax.lax.cummax(blocks, axis=2, reverse=True).reshape(B, P)
    right = _shift_left(pref, w - 1, fill)[:, :L]
    return jnp.maximum(suf[:, :L], right)


def _sort_compact(keep: jnp.ndarray, operands: list[jnp.ndarray]):
    """Stable-compact kept entries to the row front via one multi-operand
    sort — the plain reference for _shift_compact; returns (sorted
    operands, counts).  Dropped entries must already hold their padding
    value."""
    flag = (~keep).astype(jnp.uint8)
    out = jax.lax.sort((flag, *operands), dimension=1, is_stable=True,
                       num_keys=1)
    return list(out[1:]), jnp.sum(keep, axis=1).astype(jnp.int32)


def _shift_compact(keep: jnp.ndarray, operands: list[jnp.ndarray],
                   fills: list | None = None):
    """Stable-compact kept entries to the row front WITHOUT a sort.

    Each kept entry's left-shift distance r = number of dropped entries
    before it, which is non-decreasing along the row, so moving elements
    by the bits of r from LSB to MSB never collides (after bits 0..k the
    position is  orig - (r mod 2^(k+1)); for kept i < j,
    (r_j mod M) - (r_i mod M) <= r_j - r_i <= j - i - 1, strict order is
    preserved).  log2(L) masked static-shift passes replace a stable sort
    per row.  Returns the same
    (operands, counts) as _sort_compact; dropped entries become `fills`
    (default: the INF padding) instead of riding to the row tail.
    """
    B, L = keep.shape
    if fills is None:
        fills = [INF] * len(operands)
    cvk = jnp.cumsum(keep, axis=1, dtype=jnp.int32)
    count = cvk[:, -1]
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    r = jnp.where(keep, col - cvk + 1, 0)
    outs = [jnp.where(keep, a, jnp.asarray(f, a.dtype))
            for a, f in zip(operands, fills)]
    for k in range(max(1, (L - 1).bit_length())):
        bit = jnp.int32(1 << k)
        r_s = _shift_left(r, 1 << k, jnp.int32(0))
        take = (r_s & bit) != 0
        stay = (r & bit) == 0
        outs = [jnp.where(take, _shift_left(a, 1 << k, jnp.asarray(f, a.dtype)),
                          jnp.where(stay, a, jnp.asarray(f, a.dtype)))
                for a, f in zip(outs, fills)]
        r = jnp.where(take, r_s, jnp.where(stay, r, 0))
    return outs, count


def sketch_impl(codes: jnp.ndarray, lengths: jnp.ndarray, rids: jnp.ndarray,
                *, w: int, k: int):
    """Sketch a padded batch of reads.

    Args:
      codes:   [B, L] uint8 2-bit base codes (4 = ambiguous/padding).
      lengths: [B] int32 true read lengths.
      rids:    [B] uint32 read ids (encoded into y).
      w, k:    window / k-mer size (static).

    Returns:
      (x [B, L] uint64, y [B, L] uint64, count [B] int32) — per-read
      minimizers compacted to the row front, padding = INF.

    For k <= 16 the stream rides in two uint32 planes
    (_sketch_impl_packed), so the compactions — the kernel's cost center,
    each pass moving every operand through memory — and the window minima
    move 32-bit lanes.  One documented consequence: the incomplete-window sentinel is hash 0, so a
    k-mer whose 32-bit hash is exactly 0 (p = 2^-32) can emit from a
    warmup window near a reset — superset-only, same class as the other
    reset-edge divergences above.
    """
    assert 0 < w < 256 and 0 < k <= 28
    if k <= 16:
        return _sketch_impl_packed(codes, lengths, rids, w=w, k=k)
    return _sketch_impl_wide(codes, lengths, rids, w=w, k=k)


def _sketch_impl_packed(codes: jnp.ndarray, lengths: jnp.ndarray,
                        rids: jnp.ndarray, *, w: int, k: int):
    """k <= 16 fast path: the whole stream rides in TWO uint32 planes —
    H = hash, P = pos<<2|strand<<1|amb — so every hot pass moves 32-bit
    lanes; uint64 x/y records are assembled only at the very end."""
    B, L = codes.shape
    assert (L - 1).bit_length() + 2 <= 32
    mask = jnp.uint32((1 << (2 * k)) - 1)
    INF32 = jnp.uint32(0xFFFFFFFF)
    pos = jnp.arange(L)[None, :]

    c = codes.astype(jnp.int32)
    inlen = pos < lengths[:, None]
    valid = (c < 4) & inlen
    amb = (c >= 4) & inlen

    # rolling k-mers in uint32 (hash is at most 32 bits for k <= 16)
    cb = (c & 3).astype(jnp.uint32)
    cbr = cb ^ jnp.uint32(3)
    fwd = jnp.zeros((B, L), jnp.uint32)
    rev = jnp.zeros((B, L), jnp.uint32)
    for d in range(k):
        cd = _shift_right(cb, d, jnp.uint32(0))
        cdr = _shift_right(cbr, d, jnp.uint32(0))
        fwd = fwd | (cd << jnp.uint32(2 * d))
        rev = rev | (cdr << jnp.uint32(2 * (k - 1 - d)))
    fwd = fwd & mask

    sym = (fwd == rev) & valid
    strand = jnp.where(fwd < rev, jnp.uint32(0), jnp.uint32(1))
    hsh = hash64(jnp.minimum(fwd, rev), mask)

    vns = valid & ~sym
    cvns = jnp.cumsum(vns, axis=1).astype(jnp.int32)
    at_amb = jax.lax.cummax(jnp.where(amb, cvns, 0), axis=1)
    l = cvns - at_amb
    defined = vns & (l >= k)

    # warmup and ambiguous entries carry hash 0xFFFFFFFF (the reference
    # ring buffer holds UINT64_MAX there, src/mm_sketch.c:118-127)
    H = jnp.where(defined, hsh, INF32)
    Pl = ((pos.astype(jnp.uint32) << jnp.uint32(2))
          | (strand << jnp.uint32(1)) | amb.astype(jnp.uint32))
    inc = vns | amb
    (sH, sPl), n = _shift_compact(inc, [H, Pl],
                                  fills=[0xFFFFFFFF, 0xFFFFFFFF])

    scol = jnp.arange(L)[None, :]
    in_n = scol < n[:, None]
    samb = ((sPl & jnp.uint32(1)) != 0) & in_n
    # every stream entry is svns or an amb placeholder, so the svns
    # count since the last reset is just the column distance to the
    # last amb (one prefix-max instead of a prefix-sum + prefix-max)
    last_amb = jax.lax.cummax(jnp.where(samb, scol, -1), axis=1)
    sl = (scol - last_amb).astype(jnp.int32)

    W = _sliding_min_trailing(sH, w, INF32)
    complete = sl >= (w + k - 1)
    Ap = jnp.where(complete & in_n, W, jnp.uint32(0))
    M = _sliding_max_leading(Ap, w, jnp.uint32(0))
    emit = (sH != INF32) & (M == sH)

    in_final = (scol >= (n[:, None] - w)) & in_n
    xm = jnp.where(in_final, sH, INF32)
    fmin = jnp.min(xm, axis=1)
    t_f = jnp.max(jnp.where((xm == fmin[:, None]) & in_final, scol, -1),
                  axis=1)
    has_final = (fmin != INF32) & (t_f >= 0)
    emit = emit | ((scol == t_f[:, None]) & has_final[:, None])

    (oH, oPl), count = _shift_compact(emit, [sH, sPl],
                                      fills=[0xFFFFFFFF, 0xFFFFFFFF])

    out_valid = scol < count[:, None]
    ox = jnp.where(out_valid,
                   (oH.astype(jnp.uint64) << jnp.uint64(8)) | jnp.uint64(k),
                   INF)
    oy = jnp.where(
        out_valid,
        (rids[:, None].astype(jnp.uint64) << jnp.uint64(32))
        | ((oPl.astype(jnp.uint64) >> jnp.uint64(2)) << jnp.uint64(1))
        | ((oPl.astype(jnp.uint64) >> jnp.uint64(1)) & jnp.uint64(1)),
        INF)
    return ox, oy, count


def _sketch_impl_wide(codes: jnp.ndarray, lengths: jnp.ndarray,
                      rids: jnp.ndarray, *, w: int, k: int):
    B, L = codes.shape
    kdt = jnp.uint32 if k <= 16 else jnp.uint64
    mask = jnp.asarray((1 << (2 * k)) - 1, kdt)
    pos = jnp.arange(L)[None, :]

    c = codes.astype(jnp.int32)
    inlen = pos < lengths[:, None]
    valid = (c < 4) & inlen
    amb = (c >= 4) & inlen

    # --- rolling k-mers on raw positions ---------------------------------
    cb = (c & 3).astype(kdt)
    cbr = cb ^ jnp.asarray(3, kdt)  # complement codes
    fwd = jnp.zeros((B, L), kdt)
    rev = jnp.zeros((B, L), kdt)
    for d in range(k):
        # pad value 0 mirrors the zero-initialized rolling registers; the
        # complement stream is xor'd BEFORE shifting so missing entries
        # contribute zero bits on both strands (src/mm_sketch.c:102-103)
        cd = _shift_right(cb, d, jnp.asarray(0, kdt))
        cdr = _shift_right(cbr, d, jnp.asarray(0, kdt))
        fwd = fwd | (cd << jnp.asarray(2 * d, kdt))
        rev = rev | (cdr << jnp.asarray(2 * (k - 1 - d), kdt))
    fwd = fwd & mask

    sym = (fwd == rev) & valid
    strand = jnp.where(fwd < rev, 0, 1).astype(jnp.uint64)
    hsh = hash64(jnp.minimum(fwd, rev), mask).astype(jnp.uint64)

    vns = valid & ~sym  # enters the window buffer with a real payload

    # --- run length l: valid non-symmetric entries since last ambiguous --
    cvns = jnp.cumsum(vns, axis=1).astype(jnp.int32)
    at_amb = jax.lax.cummax(jnp.where(amb, cvns, 0), axis=1)
    l = cvns - at_amb

    defined = vns & (l >= k)
    x = jnp.where(defined, (hsh << jnp.uint64(8)) | jnp.uint64(k), INF)
    y = jnp.where(
        defined,
        (rids[:, None].astype(jnp.uint64) << jnp.uint64(32))
        | ((pos.astype(jnp.uint64) << jnp.uint64(1)) & jnp.uint64(0xFFFFFFFE))
        | strand,
        INF)

    # --- compact the buffer stream (placeholders for ambiguous bases) ----
    inc = vns | amb
    li = jnp.where(inc & vns, l, 0)
    x = jnp.where(inc & defined, x, INF)
    (sx, sy, sl), n = _shift_compact(inc, [x, y, li],
                                     fills=[INF, INF, jnp.int32(0)])

    # --- window minima + emission set ------------------------------------
    W = _sliding_min_trailing(sx, w, INF)
    complete = sl >= (w + k - 1)
    # sentinel 0 is below every finite x (x >= span > 0) and never equals one
    Ap = jnp.where(complete & (jnp.arange(L)[None, :] < n[:, None]),
                   W, jnp.uint64(0))
    M = _sliding_max_leading(Ap, w, jnp.uint64(0))
    emit = (sx != INF) & (M == sx)

    # --- final held minimum: min of the last window, newest tie wins -----
    spos = jnp.arange(L)[None, :]
    in_final = (spos >= (n[:, None] - w)) & (spos < n[:, None])
    xm = jnp.where(in_final, sx, INF)
    fmin = jnp.min(xm, axis=1)
    t_f = jnp.max(jnp.where((xm == fmin[:, None]) & in_final, spos, -1), axis=1)
    has_final = (fmin != INF) & (t_f >= 0)
    emit = emit | ((spos == t_f[:, None]) & has_final[:, None])

    # --- output compaction ----------------------------------------------
    ox = jnp.where(emit, sx, INF)
    oy = jnp.where(emit, sy, INF)
    (ox, oy), count = _shift_compact(emit, [ox, oy])
    return ox, oy, count


sketch_batch = jax.jit(sketch_impl, static_argnames=("w", "k"))


@functools.partial(jax.jit, static_argnames=("w", "k", "cap"))
def sketch_batch_capped(codes, lengths, rids, *, w: int, k: int, cap: int):
    """sketch_impl with outputs sliced to `cap` entries per row before they
    leave the device.  Minimizer density is ~2/(w+1), so cap = L//8 is >5x
    headroom at the default w=80; the full count is returned so callers can
    detect the (pathological) overflow and refetch uncapped.  Cuts the
    device->host transfer of the [B, L] uint64 planes 8x."""
    ox, oy, count = sketch_impl(codes, lengths, rids, w=w, k=k)
    return ox[:, :cap], oy[:, :cap], count


def sketch_reads_np(codes: np.ndarray, lengths: np.ndarray, rids: np.ndarray,
                    w: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Host convenience: run sketch_batch and flatten to concatenated
    (x, y) arrays in rid order (the reference's per-chunk mmlist layout)."""
    ox, oy, cnt = jax.device_get(
        sketch_batch(jnp.asarray(codes), jnp.asarray(lengths),
                     jnp.asarray(rids), w=w, k=k))
    xs, ys = [], []
    for b in range(len(cnt)):
        xs.append(ox[b, :cnt[b]])
        ys.append(oy[b, :cnt[b]])
    return (np.concatenate(xs) if xs else np.zeros(0, np.uint64),
            np.concatenate(ys) if ys else np.zeros(0, np.uint64))


def sketch_long_np(codes: np.ndarray, rid: int, w: int, k: int,
                   seg: int = 1 << 15, margin: int = 1 << 12
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Sketch one long sequence (contig/reference) via fixed-shape segments.

    Long inputs would otherwise compile a fresh kernel per length.  The
    sequence is cut into `seg`-sized ownership ranges, each padded with
    `margin` context on both sides; an emission at position p depends only
    on stream entries within ~w+k of p, so owned emissions of the padded
    segments equal the whole-sequence emission set (the final-held
    minimum of a non-final segment lands in the right margin and is
    dropped by ownership filtering; the true final-held belongs to the
    last segment).  Validated against the single-shot kernel in tests.
    """
    import jax as _jax
    import jax.numpy as _jnp

    n = len(codes)
    pad = seg + 2 * margin
    cap = max(256, pad // 8)  # >5x the expected 2/(w+1) minimizer density
    if n <= seg + 2 * margin:
        batch = np.full((1, pad), 4, np.uint8)
        batch[0, :n] = codes
        x, y, c = _jax.device_get(sketch_batch_capped(
            _jnp.asarray(batch), _jnp.asarray([n], np.int32),
            _jnp.asarray([rid], np.uint32), w=w, k=k, cap=cap))
        if c[0] > cap:  # pathological density: refetch uncapped
            x, y, c = _jax.device_get(sketch_batch(
                _jnp.asarray(batch), _jnp.asarray([n], np.int32),
                _jnp.asarray([rid], np.uint32), w=w, k=k))
        return x[0, :c[0]], y[0, :c[0]]

    starts = list(range(0, n, seg))
    SB = 64  # fixed batch shape: contig length must not recompile kernels
    # all batches are dispatched before any result is read (one bulk
    # fetch instead of a host sync per batch), and only the capped output
    # prefix leaves the device; a batch whose true count exceeds the cap is
    # refetched uncapped (never seen in practice)
    inputs = []
    handles = []
    for b0 in range(0, len(starts), SB):
        part = starts[b0:b0 + SB]
        batch = np.full((SB, pad), 4, np.uint8)
        lens = np.zeros(SB, np.int32)
        for i, s in enumerate(part):
            lo = max(0, s - margin)
            hi = min(n, s + seg + margin)
            batch[i, :hi - lo] = codes[lo:hi]
            lens[i] = hi - lo
        args = (_jnp.asarray(batch), _jnp.asarray(lens),
                _jnp.asarray(np.zeros(SB, np.uint32)))
        inputs.append((args, len(part)))
        handles.append(sketch_batch_capped(*args, w=w, k=k, cap=cap))
    fetched = _jax.device_get(handles)
    xparts = []
    yparts = []
    cparts = []
    for (args, npart), (x, y, c) in zip(inputs, fetched):
        if (c > cap).any():
            x, y, c = _jax.device_get(sketch_batch(*args, w=w, k=k))
        xparts.append(x[:npart])
        yparts.append(y[:npart])
        cparts.append(c[:npart])
    x = np.concatenate(xparts)
    y = np.concatenate(yparts)
    c = np.concatenate(cparts)

    xs, ys = [], []
    for i, s in enumerate(starts):
        offs_i = max(0, s - margin)
        xi = x[i, :c[i]]
        yi = y[i, :c[i]]
        pos = ((yi & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64) \
            + offs_i
        own_lo, own_hi = s, min(n, s + seg)
        keep = (pos >= own_lo) & (pos < own_hi)
        # reconstruct y with global positions and the real rid
        strand = yi & np.uint64(1)
        yg = ((np.uint64(rid) << np.uint64(32))
              | ((pos.astype(np.uint64) << np.uint64(1))
                 & np.uint64(0xFFFFFFFE)) | strand)
        xs.append(xi[keep])
        ys.append(yg[keep])
    return np.concatenate(xs), np.concatenate(ys)
