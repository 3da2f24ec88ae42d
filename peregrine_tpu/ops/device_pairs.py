"""Device pair-map + bucket-stream build.

The stage-2 prologue (build_map semantics, reference
src/shmr_utils.c:295-404) expressed as XLA sorts + elementwise passes on
uint32 planes:

* MC counts come from a sort self-join on the index hashes (the MC table
  IS the in-index multiplicity, ops/index.py::build_index), so nothing
  but the index planes and read lengths ever cross the host link.
* Eligibility, the first-strict-upper scan, adjacent-pair candidacy,
  and both orientation flips are elementwise u32 arithmetic; the
  previous-kept join is one cummax scan.
* The (key0, key1) pair sort and the (bucket, -pos) stream sort are
  single stable multi-operand lax.sorts (u64 keys split into u32 hi/lo
  lanes; a leading validity lane keeps padded rows out of the byte
  range).  Stability makes the result identical to the host
  concatenate + stable-sort layout, row for row.

The pipeline default is the threaded host build; this path runs under
--device-pairs.  Byte-identity with the host path is asserted in
tests/test_device_pairs.py.
"""

from __future__ import annotations

import numpy as np

_U28 = np.uint32(0xFFFFFFF)


def _split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (a >> np.uint64(32)).astype(np.uint32), a.astype(np.uint32)


def _join(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _pad_len(n: int) -> int:
    """Pad to 3-mantissa-bit classes (the repo-wide shape-class rule:
    bounded distinct shapes -> bounded compile cache)."""
    if n <= 1024:
        return 1024
    b = max(0, n.bit_length() - 4)
    return -(-n >> b) << b


def _kernel(xh, xl, yh, yl, rl, n, lower, upper, min_dist, ovlp_upper):
    import jax.numpy as jnp
    from jax import lax

    N = xh.shape[0]
    i32 = jnp.int32
    iota = lax.iota(i32, N)
    valid = iota < n

    # --- counts: sort self-join on the 56-bit hash -----------------------
    hh = jnp.where(valid, xh >> 8, jnp.uint32(0xFFFFFFFF))
    hl = jnp.where(valid, (xh << 24) | (xl >> 8), jnp.uint32(0xFFFFFFFF))
    s_hh, s_hl, s_idx = lax.sort((hh, hl, iota), num_keys=2, is_stable=True)
    first = jnp.concatenate([jnp.ones(1, bool),
                             (s_hh[1:] != s_hh[:-1]) | (s_hl[1:] != s_hl[:-1])])
    run_start = lax.cummax(jnp.where(first, iota, 0))
    last = jnp.concatenate([first[1:], jnp.ones(1, bool)])
    run_end = lax.cummin(jnp.where(last, iota + 1, N)[::-1])[::-1]
    cnt_sorted = (run_end - run_start).astype(jnp.uint32)
    # restore original order: scatter back through the carried original
    # index (a permutation).  XLA rewrites a sort keyed by a permutation
    # into this same scatter; on the GPU that rewrite built an ill-typed
    # scatter for a u32 payload under an s32 key, which the HLO verifier
    # rejected.
    counts = jnp.zeros(N, jnp.uint32).at[s_idx].set(cnt_sorted,
                                                    unique_indices=True)

    # --- eligibility + first strict-upper entry --------------------------
    lo32, up32 = jnp.uint32(lower), jnp.uint32(upper)
    elig = (counts >= lo32) & (counts <= up32) & valid
    first_ok = (counts >= lo32) & (counts < up32) & valid
    any_ok = first_ok.any()
    s0 = jnp.argmax(first_ok).astype(i32)
    keep = elig & (iota >= s0) & any_ok

    # --- adjacent-kept candidates (prev-kept via cummax scan) ------------
    pk = lax.cummax(jnp.where(keep, iota, i32(-1)))
    prev = jnp.concatenate([jnp.full(1, -1, i32), pk[:-1]])
    pidx = jnp.maximum(prev, 0)
    yh_p = jnp.take(yh, pidx)
    yl_p = jnp.take(yl, pidx)
    xh_p = jnp.take(xh, pidx)
    xl_p = jnp.take(xl, pidx)
    pos_p = (yl_p >> 1) & _U28
    pos_i = (yl >> 1) & _U28
    dist = pos_i - pos_p  # u32 wraparound == the host u64-truncate
    cand = keep & (prev >= 0) & (yh == yh_p) & (dist >= jnp.uint32(min_dist))
    n_cand = cand.sum()

    # --- orientation flips (reverse records swap and strand-flip) --------
    def flip(yh_v, yl_v, xl_v):
        span = xl_v & jnp.uint32(0xFF)
        pos = (yl_v >> 1) + 1
        rpos = jnp.take(rl, yh_v.astype(i32), mode="clip") - pos + span - 1
        return ((yl_v & 1) | (rpos << 1)) ^ 1

    # forward block: (x_p, x_i, y_p, y_i, dir 0); reverse: (x_i, x_p,
    # flip(y_i), flip(y_p), dir 1) — exactly the host concatenate layout
    inval_f = ~cand
    k0h = jnp.concatenate([xh_p, xh])
    k0l = jnp.concatenate([xl_p, xl])
    k1h = jnp.concatenate([xh, xh_p])
    k1l = jnp.concatenate([xl, xl_p])
    y0h = jnp.concatenate([yh_p, yh])
    y0l = jnp.concatenate([yl_p, flip(yh, yl, xl)])
    y1h = jnp.concatenate([yh, yh_p])
    y1l = jnp.concatenate([yl, flip(yh_p, yl_p, xl_p)])
    dirv = jnp.concatenate([jnp.zeros(N, jnp.uint32), jnp.ones(N, jnp.uint32)])
    inval = jnp.concatenate([inval_f, inval_f]).astype(jnp.uint32)

    rec = lax.sort((inval, k0h, k0l, k1h, k1l, y0h, y0l, y1h, y1l, dirv),
                   num_keys=5, is_stable=True)
    (r_inval, r_k0h, r_k0l, r_k1h, r_k1l,
     r_y0h, r_y0l, r_y1h, r_y1l, r_dir) = rec
    rvalid = r_inval == 0
    r_inval_ref = r_inval

    # --- bucket stream ---------------------------------------------------
    M = 2 * N
    miota = lax.iota(i32, M)
    bfirst = jnp.concatenate([
        jnp.ones(1, bool),
        (r_k0h[1:] != r_k0h[:-1]) | (r_k0l[1:] != r_k0l[:-1])
        | (r_k1h[1:] != r_k1h[:-1]) | (r_k1l[1:] != r_k1l[:-1])
        # the validity lane is a run boundary too: a padded row that
        # happens to share the last valid bucket's key must not inflate
        # that bucket's size
        | (r_inval_ref[1:] != r_inval_ref[:-1])])
    brank = jnp.cumsum(bfirst.astype(i32)) - 1
    bstart = lax.cummax(jnp.where(bfirst, miota, 0))
    blast = jnp.concatenate([bfirst[1:], jnp.ones(1, bool)])
    bend = lax.cummin(jnp.where(blast, miota + 1, M)[::-1])[::-1]
    bsize = bend - bstart
    s_elig = (bsize > 2) & (bsize <= ovlp_upper) & rvalid
    n_stream = s_elig.sum()
    spos = (r_y0l >> 1) & _U28
    st = lax.sort(((~s_elig).astype(jnp.uint32), brank.astype(jnp.uint32),
                   ~spos, r_y0h, r_y0l, r_dir),
                  num_keys=3, is_stable=True)
    _, st_brank, _, st_y0h, st_y0l, st_dir = st

    return (n_cand, r_k0h, r_k0l, r_k1h, r_k1l, r_y0h, r_y0l, r_y1h, r_y1l,
            r_dir, n_stream, st_y0h, st_y0l, st_dir, st_brank)


_jitted = None


def _get_kernel():
    global _jitted
    if _jitted is None:
        import jax
        _jitted = jax.jit(_kernel,
                          static_argnames=("lower", "upper", "min_dist",
                                           "ovlp_upper"))
    return _jitted


def build_pairs_device(idx, read_lengths: np.ndarray, mc_lower: int = 2,
                       mc_upper: int = 240, min_dist: int = 100,
                       ovlp_upper: int = 120):
    """Pair map + bucket stream on the device.  Returns
    (pairs, stream): pairs = (key0, key1, y0, y1, dir) byte-identical to
    ops.overlap.build_pairs (single chunk), stream = (ys, dirs, pos,
    bstart, bend) byte-identical to ops.overlap.bucket_stream."""
    import jax
    import jax.numpy as jnp

    n = len(idx.x)
    N = _pad_len(max(n, 2))
    xh, xl = _split(np.ascontiguousarray(idx.x, np.uint64))
    yh, yl = _split(np.ascontiguousarray(idx.y, np.uint64))

    def pad(a):
        return np.pad(a, (0, N - n))

    rl = np.ascontiguousarray(read_lengths, np.int64).astype(np.uint32)
    out = _get_kernel()(jnp.asarray(pad(xh)), jnp.asarray(pad(xl)),
                        jnp.asarray(pad(yh)), jnp.asarray(pad(yl)),
                        jnp.asarray(rl), n,
                        lower=int(mc_lower), upper=int(mc_upper),
                        min_dist=int(min_dist), ovlp_upper=int(ovlp_upper))
    n_cand = int(out[0])
    n_rec = 2 * n_cand
    n_stream = int(out[10])
    # slice on device, fetch only the valid prefixes in one bulk get
    fetched = jax.device_get([o[:n_rec] for o in out[1:10]]
                             + [o[:n_stream] for o in out[11:15]])
    (k0h, k0l, k1h, k1l, y0h, y0l, y1h, y1l, dirv,
     st_y0h, st_y0l, st_dir, st_brank) = fetched
    key0 = _join(k0h, k0l)
    key1 = _join(k1h, k1l)
    y0 = _join(y0h, y0l)
    y1 = _join(y1h, y1l)
    direction = dirv.astype(np.uint8)

    ys = _join(st_y0h, st_y0l)
    dirs = st_dir.astype(np.uint8)
    pos = ((st_y0l >> np.uint32(1)) & _U28).astype(np.int64)
    # bucket bounds from the brank runs (host diff; tiny)
    if n_stream:
        change = np.flatnonzero(st_brank[1:] != st_brank[:-1]) + 1
        bounds = np.concatenate([[0], change, [n_stream]]).astype(np.int64)
        bs, be = bounds[:-1], bounds[1:]
    else:
        bs = be = np.zeros(0, np.int64)
    return ((key0, key1, y0, y1, direction), (ys, dirs, pos, bs, be))
