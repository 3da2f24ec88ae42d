"""Multi-device SHIMMER indexing: data-parallel sketch + hash-shard exchange.

The reference parallelizes indexing by read chunks and overlap by minimizer
hash, with files as the interconnect (SURVEY.md §2.3).  On a device mesh both
shardings become one device program:

1. reads are sharded over the mesh's ``data`` axis; each device sketches
   and reduces its shard (ops.index.index_step),
2. each record is routed to the device owning its hash shard
   (``hash % n_devices``) via a fixed-capacity ``all_to_all``,
3. each device sorts its received records by (hash, y) — the bucket
   layout the overlapper consumes — and computes its local minimizer
   counts by run length.

All-to-all capacity is static: per (src, dst) pair ``cap`` records;
per-destination overflow is detected via the returned send counts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.index import index_step

INF = jnp.uint64(0xFFFFFFFFFFFFFFFF)


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def _spread_right(r, operands, fills, out_len: int):
    """Move element i rightward to position i + r[i] (r int32,
    non-decreasing over kept elements; dropped elements carry r = 0 and a
    fill value).  Mirror of the log-shift compaction (ops.sketch
    _shift_compact) — but bits run MSB->LSB: rightward, positions after
    processing bits >= 2^k are i + (r_i - r_i mod 2^k), strictly
    increasing for non-decreasing r (LSB-first collides at the large r
    jumps between shard runs).  Unwritten holes become the fills."""
    n_in = r.shape[0]
    pad = out_len - n_in
    if pad > 0:
        r = jnp.pad(r, (0, pad))
        operands = [jnp.pad(a, (0, pad), constant_values=f)
                    for a, f in zip(operands, fills)]
    outs = list(operands)
    for k in reversed(range(max(1, (out_len - 1).bit_length()))):
        bit = jnp.int32(1 << k)
        r_s = jnp.pad(r[:-(1 << k)], (1 << k, 0))           # r[p - 2^k]
        take = (r_s & bit) != 0
        stay = (r & bit) == 0
        outs = [jnp.where(take,
                          jnp.pad(a[:-(1 << k)], (1 << k, 0),
                                  constant_values=f),
                          jnp.where(stay, a, jnp.asarray(f, a.dtype)))
                for a, f in zip(outs, fills)]
        r = jnp.where(take, r_s, jnp.where(stay, r, jnp.int32(0)))
    return outs


def _route_local(x, y, count, n_shards: int, cap: int):
    """Pack local records into [n_shards, cap] send buffers by hash shard.

    Sort by target shard, then spread each shard's run to its fixed
    cap-aligned offset with log-shift passes — a scatter formulation
    (.at[dest].set) is avoided so the routing stays sort + elementwise.
    """
    B, C = x.shape
    xf = x.reshape(-1)
    yf = y.reshape(-1)
    total = B * C
    valid = (jnp.arange(C)[None, :] < count[:, None]).reshape(-1)
    tgt = jnp.where(valid, (xf >> jnp.uint64(8)) % jnp.uint64(n_shards),
                    jnp.uint64(n_shards)).astype(jnp.int32)

    st, sx, sy = jax.lax.sort((tgt, xf, yf), dimension=0, is_stable=True,
                              num_keys=1)
    sent = jnp.sum(jax.nn.one_hot(st, n_shards + 1, dtype=jnp.int32),
                   axis=0)[:n_shards]
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(sent)[:-1].astype(jnp.int32)])
    idx = jnp.arange(total, dtype=jnp.int32)
    slot = idx - jnp.take(starts, jnp.minimum(st, n_shards - 1))
    keep = (st < n_shards) & (slot < cap)
    dest = jnp.where(keep, st * cap + slot, 0)

    # kept records are already in ascending-dest order (the sort groups
    # shards; slot grows within a shard run), but dropped records sit
    # between them and the local stream may be LONGER than the send
    # buffer, leaving kept elements past their destination.  Compact the
    # kept records to the front first (left log-shift), then spread right
    # — after compaction position p <= dest[p] always holds.
    from ..ops.sketch import _shift_compact
    (sxc, syc, dstc), _ = _shift_compact(
        keep[None, :], [sx[None, :], sy[None, :], dest[None, :]],
        [INF, INF, 0])
    out_len = n_shards * cap
    kept_total = jnp.minimum(jnp.sum(keep.astype(jnp.int32)), out_len)
    sxc, syc, dstc = (a[0, :out_len] if total >= out_len
                      else jnp.pad(a[0], (0, out_len - total),
                                   constant_values=f)
                      for a, f in ((sxc, INF), (syc, INF), (dstc, 0)))
    pos = jnp.arange(out_len, dtype=jnp.int32)
    valid2 = pos < kept_total
    r = jnp.where(valid2, dstc.astype(jnp.int32) - pos, 0)
    send_x, send_y = _spread_right(r, [jnp.where(valid2, sxc, INF),
                                       jnp.where(valid2, syc, INF)],
                                   [INF, INF], out_len)
    return (send_x.reshape(n_shards, cap), send_y.reshape(n_shards, cap),
            sent)


def sharded_index(mesh: Mesh, codes, lengths, rids, *, w: int, k: int,
                  r: int, levels: int, cap_per_pair: int, axis: str = "data"):
    """Full multi-device index step over ``mesh``.

    Args:
      codes/lengths/rids: global arrays, shardable on dim 0 over the mesh.
      cap_per_pair: static per-(src,dst) record capacity for the exchange.

    Returns per-device concatenated (x, y) records sorted by hash (global
    shape [n*cap*n? ...] sharded on dim 0), local record validity counts,
    and per-source sent counts for overflow detection.
    """
    fn = _build_sharded_index(mesh, axis, mesh.devices.size, w, k, r,
                              levels, cap_per_pair)
    return fn(codes, lengths, rids)


@functools.lru_cache(maxsize=64)
def _build_sharded_index(mesh: Mesh, axis: str, n: int, w: int, k: int,
                         r: int, levels: int, cap_per_pair: int):
    """jit-wrapped shard_map program, cached per (mesh, params) — building
    it per call re-lowered the whole program every invocation."""

    def local(codes, lengths, rids):
        sketch_cap = max(256, codes.shape[1] // 8)
        x, y, c, c0 = index_step(codes, lengths, rids, w=w, k=k, r=r,
                                 levels=levels, cap=sketch_cap,
                                 tight_out=False)
        overflow = jnp.any(c0 > sketch_cap).astype(jnp.int32)
        send_x, send_y, sent = _route_local(x, y, c, n, cap_per_pair)
        # exchange: row i of the send buffer goes to device i
        recv_x = jax.lax.all_to_all(send_x, axis, 0, 0, tiled=True)
        recv_y = jax.lax.all_to_all(send_y, axis, 0, 0, tiled=True)
        rx = recv_x.reshape(-1)
        ry = recv_y.reshape(-1)
        # bucket layout: sort received records by (hash-key, position key)
        rx, ry = jax.lax.sort((rx, ry), dimension=0, num_keys=2)
        nvalid = jnp.sum(rx != INF).astype(jnp.int32)
        return (rx[None, :], ry[None, :], nvalid[None], sent[None, :],
                overflow[None])

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=(P(axis, None), P(axis, None), P(axis), P(axis, None),
                   P(axis))))


def build_index_mesh(db, cfg, mesh: Mesh | None = None,
                     rid_filter: np.ndarray | None = None):
    """Stage-1 SHIMMER index on a device mesh (pipeline entry point).

    Reads are sharded over the mesh's data axis; every device sketches and
    hierarchically reduces its shard (ops.index.index_step) and the records
    ride the hash all_to_all exchange (sharded_index) — the mesh analog of
    the reference's N shmr_index processes + the overlapper's per-chunk
    hash filter (src/shmr_index.c:157, src/shmr_utils.c:337).  The
    hash-sharded shards are then re-ordered by y (rid<<32|pos) into the
    rid-ordered layout every downstream stage consumes, so the result is
    identical to ops.index.build_index (asserted in tests/test_sharded.py).
    """
    import jax

    from ..ops.index import (ShimmerIndex, _length_buckets, _merge_counts)

    if mesh is None:
        mesh = make_mesh()
    n = mesh.devices.size
    rids_all = (np.arange(len(db)) if rid_filter is None
                else np.asarray(rid_filter))
    lengths = db.lengths[rids_all].astype(np.int64)
    xs_parts: list[np.ndarray] = []
    ys_parts: list[np.ndarray] = []

    # long sequences (contigs/references) take the fixed-shape segmented
    # host path, exactly as ops.index.build_index does
    long_thresh = 2 * cfg.sketch_pad_len
    long_sel = lengths > long_thresh
    if long_sel.any():
        from ..ops.reduce import reduce_flat_np
        from ..ops.sketch import sketch_long_np
        for rid in rids_all[long_sel]:
            lx, ly = sketch_long_np(db.codes(rid), int(rid), cfg.w, cfg.k,
                                    seg=cfg.sketch_pad_len)
            for _ in range(cfg.levels):
                lx, ly = reduce_flat_np(lx, ly, cfg.r)
            xs_parts.append(lx)
            ys_parts.append(ly)
        rids_all = rids_all[~long_sel]
        lengths = lengths[~long_sel]

    bucket_unit = max(2048, cfg.sketch_pad_len // 4)
    for pad, sel in _length_buckets(lengths, bucket_unit).items():
        batch_rids = rids_all[sel]
        per_dev = max(1, min(cfg.sketch_batch,
                             (cfg.sketch_batch * cfg.sketch_pad_len) // pad))
        bsz = per_dev * n
        # worst-case per-source record count (sketch cap) so the exchange
        # can never overflow even if one shard owns every hash
        cap = max(256, per_dev * (pad // 8))
        for i in range(0, len(batch_rids), bsz):
            part = batch_rids[i:i + bsz]
            codes, lens = db.padded_code_batch(part, pad)
            shards = sharded_index_host(
                mesh, codes, lens, part.astype(np.uint32), w=cfg.w, k=cfg.k,
                r=cfg.r, levels=cfg.levels, cap_per_pair=cap)
            for sx, sy in shards:
                xs_parts.append(sx)
                ys_parts.append(sy)

    if xs_parts:
        x = np.concatenate(xs_parts)
        y = np.concatenate(ys_parts)
    else:
        x = np.zeros(0, np.uint64)
        y = np.zeros(0, np.uint64)
    # y = rid<<32|pos<<1|strand is ascending within each read's emitted
    # records, so a stable sort by y reconstructs the rid-ordered layout
    # (threaded native pass; the one-core numpy argsort cost ~15 s at
    # 250 Mb scale — a redundant-sort seam)
    from ..native import sort_by_y
    x = np.ascontiguousarray(x)
    y = np.ascontiguousarray(y)
    sort_by_y(y, x)
    mh, mc = _merge_counts(x >> np.uint64(8), np.ones(len(x), np.uint32))
    return ShimmerIndex(x, y, mh, mc)


def sharded_index_host(mesh: Mesh, codes: np.ndarray, lengths: np.ndarray,
                       rids: np.ndarray, *, w: int, k: int, r: int,
                       levels: int, cap_per_pair: int | None = None):
    """Host wrapper: pads the batch to the mesh size and returns per-shard
    (x, y) record arrays (hash-sharded, sorted)."""
    n = mesh.devices.size
    B, L = codes.shape
    pad = (-B) % n
    if pad:
        codes = np.concatenate([codes, np.full((pad, L), 4, np.uint8)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
        rids = np.concatenate([rids, np.zeros(pad, rids.dtype)])
    cap = cap_per_pair or max(256, (B + n - 1) // n * L // (8 * n) * 2)
    out = sharded_index(mesh, jnp.asarray(codes), jnp.asarray(lengths),
                        jnp.asarray(rids), w=w, k=k, r=r, levels=levels,
                        cap_per_pair=cap)
    if jax.process_count() > 1:
        # multi-controller: device_get cannot read non-addressable shards.
        # Re-shard to fully-replicated (an all-gather collective every
        # rank executes in lockstep), after which every shard is local and
        # each host sees the identical full index — the host stages that
        # consume it run on rank 0.
        from jax.sharding import NamedSharding
        rep = jax.jit(lambda t: t,
                      out_shardings=NamedSharding(mesh, P()))(out)
        rx, ry, nv, sent, overflow = (np.asarray(o) for o in rep)
    else:
        rx, ry, nv, sent, overflow = jax.device_get(out)
    if (sent > cap).any():
        raise ValueError(f"all_to_all capacity {cap} overflowed: {sent.max()}")
    if overflow.any():
        raise ValueError(
            "sketch cap overflowed on a device shard; raise the pad length "
            "(records would be silently truncated otherwise)")
    shards = []
    for d in range(n):
        shards.append((rx[d, :nv[d]], ry[d, :nv[d]]))
    return shards
