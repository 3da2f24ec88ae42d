"""Multi-device pair-map + bucket-stream build (mesh stage-2 prologue).

The overlap pair map is derived from read-sharded index planes entirely on the mesh —
no host sorts, no rid-order round trip — and the per-shard outputs
concatenate to the EXACT byte layout of the single-chip/host build:

1. index entries are sharded by contiguous read ranges (adjacent-pair
   candidacy never crosses a read, so shard cuts at read boundaries are
   exact); the replicated MC table provides global counts, and the
   global first-strict-upper entry is an all_gather'd min;
2. each shard emits both orientation records tagged with a GLOBAL
   candidate rank (exclusive-scanned over shards), the tiebreak that
   reproduces the host path's stable concatenate-then-sort order;
3. records ride a fixed-capacity all_to_all to the shard owning their
   key0 — routed by *top hash bits* ((hash * n) >> 56), which is
   order-preserving, so shard-major concatenation IS ascending key0
   order (a modulo shard would scramble the global bucket order);
4. every shard sorts its received records by (key0, key1, rank) and
   builds its local bucket stream (bucket sizes cannot cross shards:
   equal key0 lands on one shard).

At human scale the pair map alone is ~14 GB + sort workspace; this
shards both the memory and the sort across the mesh.
Byte-identity with the host build is asserted on the virtual CPU mesh
(tests/test_sharded_pairs.py).  Reference analog: build_map,
src/shmr_utils.c:295-404 (one process per hash chunk, files as the
interconnect).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

U64_MAX = jnp.uint64(0xFFFFFFFFFFFFFFFF)
_U28 = jnp.uint64(0xFFFFFFF)


def _spread_right_multi(r, operands, fills, out_len: int):
    """_spread_right (sharded_index) generalized to any operand count."""
    n_in = r.shape[0]
    pad = out_len - n_in
    if pad > 0:
        r = jnp.pad(r, (0, pad))
        operands = [jnp.pad(a, (0, pad), constant_values=f)
                    for a, f in zip(operands, fills)]
    outs = list(operands)
    for k in reversed(range(max(1, (out_len - 1).bit_length()))):
        bit = jnp.int32(1 << k)
        r_s = jnp.pad(r[:-(1 << k)], (1 << k, 0))
        take = (r_s & bit) != 0
        stay = (r & bit) == 0
        outs = [jnp.where(take,
                          jnp.pad(a[:-(1 << k)], (1 << k, 0),
                                  constant_values=f),
                          jnp.where(stay, a, jnp.asarray(f, a.dtype)))
                for a, f in zip(outs, fills)]
        r = jnp.where(take, r_s, jnp.where(stay, r, jnp.int32(0)))
    return outs


def _route(tgt, lanes, fills, n_shards: int, cap: int):
    """Pack local records into [n_shards, cap] send buffers by target
    (sort + log-shift spread, no scatter)."""
    total = tgt.shape[0]
    order = jax.lax.sort((tgt.astype(jnp.int32),) + tuple(lanes),
                         num_keys=1, is_stable=True)
    st, lanes_s = order[0], order[1:]
    sent = jnp.sum(jax.nn.one_hot(st, n_shards + 1, dtype=jnp.int32),
                   axis=0)[:n_shards]
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(sent)[:-1].astype(jnp.int32)])
    idx = jnp.arange(total, dtype=jnp.int32)
    slot = idx - jnp.take(starts, jnp.minimum(st, n_shards - 1))
    keep = (st < n_shards) & (slot < cap)
    dest = jnp.where(keep, st * cap + slot, 0)

    from ..ops.sketch import _shift_compact
    compacted, _ = _shift_compact(
        keep[None, :], [a[None, :] for a in lanes_s] + [dest[None, :]],
        list(fills) + [0])
    out_len = n_shards * cap
    kept_total = jnp.minimum(jnp.sum(keep.astype(jnp.int32)), out_len)

    def fit(a, f):
        a = a[0]
        return (a[:out_len] if total >= out_len
                else jnp.pad(a, (0, out_len - total), constant_values=f))

    lanes_c = [fit(a, f) for a, f in zip(compacted[:-1], fills)]
    dstc = fit(compacted[-1], 0)
    pos = jnp.arange(out_len, dtype=jnp.int32)
    valid2 = pos < kept_total
    r = jnp.where(valid2, dstc.astype(jnp.int32) - pos, 0)
    spread = _spread_right_multi(
        r, [jnp.where(valid2, a, jnp.asarray(f, a.dtype))
            for a, f in zip(lanes_c, fills)], fills, out_len)
    return [a.reshape(n_shards, cap) for a in spread], sent


@functools.lru_cache(maxsize=32)
def _build_program(mesh: Mesh, axis: str, n: int, Nl: int, cap: int,
                   lower: int, upper: int, min_dist: int, ovlp_upper: int):
    def local(x, y, base, nloc, mc_hash, mc_count, rl):
        x, y = x[0], y[0]
        base = base[0]
        nloc = nloc[0]
        iota = jax.lax.iota(jnp.int32, Nl)
        valid = iota < nloc
        gpos = base + iota.astype(jnp.int64)

        # --- global counts from the replicated MC table ---------------
        h = x >> jnp.uint64(8)
        loc = jnp.searchsorted(mc_hash, h)
        locc = jnp.minimum(loc, mc_hash.shape[0] - 1)
        hit = jnp.take(mc_hash, locc) == h
        counts = jnp.where(hit, jnp.take(mc_count, locc), 0)

        lo32, up32 = jnp.uint32(lower), jnp.uint32(upper)
        elig = (counts >= lo32) & (counts <= up32) & valid
        first_ok = (counts >= lo32) & (counts < up32) & valid
        lfirst = jnp.where(first_ok.any(),
                           base + jnp.argmax(first_ok).astype(jnp.int64),
                           jnp.int64(1) << 62)
        gfirst = jnp.min(jax.lax.all_gather(lfirst, axis))
        keep = elig & (gpos >= gfirst)

        # --- adjacent-kept candidates (local: shards cut at reads) ----
        pk = jax.lax.cummax(jnp.where(keep, iota, jnp.int32(-1)))
        prev = jnp.concatenate([jnp.full(1, -1, jnp.int32), pk[:-1]])
        pidx = jnp.maximum(prev, 0)
        xp = jnp.take(x, pidx)
        yp = jnp.take(y, pidx)
        pos_p = (yp >> jnp.uint64(1)) & _U28
        pos_i = (y >> jnp.uint64(1)) & _U28
        dist = (pos_i - pos_p).astype(jnp.uint32)
        cand = keep & (prev >= 0) & ((y >> jnp.uint64(32))
                                     == (yp >> jnp.uint64(32))) \
            & (dist >= jnp.uint32(min_dist))

        # global candidate rank (the host path's stable-order tiebreak)
        n_cand = jnp.sum(cand.astype(jnp.int64))
        all_c = jax.lax.all_gather(n_cand, axis)
        me = jax.lax.axis_index(axis)
        cand_base = jnp.sum(jnp.where(jnp.arange(n) < me, all_c, 0))
        total_cand = jnp.sum(all_c)
        rank = cand_base + jnp.cumsum(cand.astype(jnp.int64)) - 1

        def flip(yv, xv):
            span = xv & jnp.uint64(0xFF)
            pos = ((yv & jnp.uint64(0xFFFFFFFF)) >> jnp.uint64(1)) \
                + jnp.uint64(1)
            rid = (yv >> jnp.uint64(32)).astype(jnp.int32)
            rpos = jnp.take(rl, rid, mode="clip").astype(jnp.uint64) \
                - pos + span - jnp.uint64(1)
            return ((yv & jnp.uint64(0xFFFFFFFF00000001))
                    | ((rpos << jnp.uint64(1)) & jnp.uint64(0xFFFFFFFF))) \
                ^ jnp.uint64(1)

        # forward block then reverse block, dirtie = rank<<1 | dir
        k0 = jnp.concatenate([xp, x])
        k1 = jnp.concatenate([x, xp])
        y0 = jnp.concatenate([yp, flip(y, x)])
        y1 = jnp.concatenate([y, flip(yp, xp)])
        dt = jnp.concatenate([
            (rank.astype(jnp.uint64) << jnp.uint64(1)),
            (((total_cand + rank).astype(jnp.uint64)) << jnp.uint64(1))
            | jnp.uint64(1)])
        cc = jnp.concatenate([cand, cand])

        # route by ORDER-PRESERVING top hash bits: (hash * n) >> 56
        tgt = jnp.where(cc, (((k0 >> jnp.uint64(8)) * jnp.uint64(n))
                             >> jnp.uint64(56)).astype(jnp.int32),
                        jnp.int32(n))
        lanes, sent = _route(tgt, (k0, k1, y0, y1, dt),
                             (U64_MAX,) * 5, n, cap)
        ex = [jax.lax.all_to_all(a.reshape(n, cap), axis, 0, 0, tiled=True)
              for a in lanes]
        rk0, rk1, ry0, ry1, rdt = (a.reshape(-1) for a in ex)

        # received-valid = not the fill sentinel on the dirtie lane
        rvalid = rdt != U64_MAX
        inval = (~rvalid).astype(jnp.uint32)
        srt = jax.lax.sort((inval, rk0, rk1, rdt, ry0, ry1),
                           num_keys=4, is_stable=False)
        s_inval, sk0, sk1, sdt, sy0, sy1 = srt
        svalid = s_inval == 0
        n_rec = jnp.sum(svalid.astype(jnp.int64))

        # --- local bucket stream --------------------------------------
        M = n * cap
        miota = jax.lax.iota(jnp.int32, M)
        bfirst = jnp.concatenate([
            jnp.ones(1, bool),
            (sk0[1:] != sk0[:-1]) | (sk1[1:] != sk1[:-1])
            | (s_inval[1:] != s_inval[:-1])])
        brank = jnp.cumsum(bfirst.astype(jnp.int32)) - 1
        bstart = jax.lax.cummax(jnp.where(bfirst, miota, 0))
        blast = jnp.concatenate([bfirst[1:], jnp.ones(1, bool)])
        bend = jax.lax.cummin(
            jnp.where(blast, miota + 1, M)[::-1])[::-1]
        bsize = bend - bstart
        s_elig = (bsize > 2) & (bsize <= ovlp_upper) & svalid
        n_stream = jnp.sum(s_elig.astype(jnp.int64))
        spos = ((sy0 & jnp.uint64(0xFFFFFFFF)) >> jnp.uint64(1)) \
            .astype(jnp.uint32)
        st = jax.lax.sort(((~s_elig).astype(jnp.uint32),
                           brank.astype(jnp.uint32), ~spos, sdt, sy0),
                          num_keys=4, is_stable=False)
        _, st_brank, _, st_dt, st_y0 = st

        out = (sk0, sk1, sy0, sy1, sdt, st_y0, st_dt, st_brank)
        return tuple(a[None] for a in out) + (
            n_rec[None], n_stream[None], sent[None])

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis), P(axis),
                  P(), P(), P()),
        out_specs=(P(axis, None),) * 8 + (P(axis), P(axis), P(axis, None)),
        check_vma=False))


def build_pairs_mesh(idx, read_lengths: np.ndarray, mesh: Mesh,
                     mc_lower: int = 2, mc_upper: int = 240,
                     min_dist: int = 100, ovlp_upper: int = 120,
                     axis: str = "data", cap: int | None = None):
    """Pair map + bucket stream over a device mesh; byte-identical to the
    host build (pairs, stream) tuple.  Falls back to the host build if
    the exchange capacity overflows (overflow is detected, never silent)."""
    from ..ops.device_pairs import _join, _pad_len
    from ..ops.overlap import bucket_stream, build_pairs

    n = mesh.devices.size
    x = np.ascontiguousarray(idx.x, np.uint64)
    y = np.ascontiguousarray(idx.y, np.uint64)
    N = len(x)
    # shard boundaries at read boundaries: split near-even by entries,
    # then advance to the next read change
    rid = (y >> np.uint64(32))
    bounds = [0]
    for d in range(1, n):
        c = min(N, d * N // n)
        while c < N and c > 0 and rid[c] == rid[c - 1]:
            c += 1
        bounds.append(max(c, bounds[-1]))
    bounds.append(N)
    sizes = [bounds[d + 1] - bounds[d] for d in range(n)]
    Nl = _pad_len(max(max(sizes), 2))
    xs = np.full((n, Nl), 0xFFFFFFFFFFFFFFFF, np.uint64)
    ys = np.zeros((n, Nl), np.uint64)
    for d in range(n):
        xs[d, :sizes[d]] = x[bounds[d]:bounds[d + 1]]
        ys[d, :sizes[d]] = y[bounds[d]:bounds[d + 1]]
    base = np.asarray(bounds[:-1], np.int64)
    nloc = np.asarray(sizes, np.int64)
    rl = np.ascontiguousarray(read_lengths, np.int64).astype(np.uint32)
    if cap is None:
        # uniform hashes: ~(2N/n) records per source spread over n
        # destinations; 3x safety, floor for tiny inputs
        cap = max(1024, int(6 * N / (n * n)))

    prog = _build_program(mesh, axis, n, Nl, cap, int(mc_lower),
                          int(mc_upper), int(min_dist), int(ovlp_upper))
    out = prog(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(base),
               jnp.asarray(nloc), jnp.asarray(idx.mc_hash),
               jnp.asarray(idx.mc_count), jnp.asarray(rl))
    (sk0, sk1, sy0, sy1, sdt, st_y0, st_dt, st_brank,
     n_rec, n_stream, sent) = out
    sent_np = np.asarray(sent)
    if (sent_np > cap).any():
        # capacity overflow: records would have been dropped — rebuild on
        # the host (correctness net; raise cap for balanced re-runs)
        pairs = build_pairs(idx, read_lengths, 1, 1, mc_lower, mc_upper,
                            min_dist)
        return pairs, bucket_stream(pairs[0], pairs[1], pairs[2], pairs[4],
                                    ovlp_upper)

    nr = np.asarray(n_rec)
    ns = np.asarray(n_stream)
    fetched = jax.device_get(
        [[sk0[d, :nr[d]], sk1[d, :nr[d]], sy0[d, :nr[d]], sy1[d, :nr[d]],
          sdt[d, :nr[d]], st_y0[d, :ns[d]], st_dt[d, :ns[d]],
          st_brank[d, :ns[d]]] for d in range(n)])
    key0 = np.concatenate([f[0] for f in fetched])
    key1 = np.concatenate([f[1] for f in fetched])
    y0 = np.concatenate([f[2] for f in fetched])
    y1 = np.concatenate([f[3] for f in fetched])
    direction = (np.concatenate([f[4] for f in fetched])
                 & np.uint64(1)).astype(np.uint8)
    sys_ = np.concatenate([f[5] for f in fetched])
    sdirs = (np.concatenate([f[6] for f in fetched])
             & np.uint64(1)).astype(np.uint8)
    pos = ((sys_ & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
    # bucket bounds: brank runs per shard, offset by prior shards
    bs_parts, be_parts = [], []
    off = 0
    for f in fetched:
        br = np.asarray(f[7])
        if len(br):
            change = np.flatnonzero(br[1:] != br[:-1]) + 1
            b = np.concatenate([[0], change, [len(br)]]).astype(np.int64)
            bs_parts.append(b[:-1] + off)
            be_parts.append(b[1:] + off)
            off += len(br)
    bs = (np.concatenate(bs_parts) if bs_parts else np.zeros(0, np.int64))
    be = (np.concatenate(be_parts) if be_parts else np.zeros(0, np.int64))
    return ((key0, key1, y0, y1, direction), (sys_, sdirs, pos, bs, be))
