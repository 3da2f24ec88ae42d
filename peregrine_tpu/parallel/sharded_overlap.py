"""Multi-device overlap alignment over a read-sharded device seqdb.

At human scale the packed seqdb no longer fits one device's memory (90
Gbases of 30x reads), so each device holds only its read shard and
alignment requests ride the interconnect to the data instead of the data
being replicated (SURVEY.md §2.3: the reference's analog is N processes
sharing one mmap; devices share no memory, so the all_to_all IS the
mmap).  Shards store the 2-bit + ambiguity planes (ops.dbgather), ~2.7x
less device memory than byte-per-base; exchanged query windows ride the
all_to_all 2-bit packed as well.

Execution model per batch of (query read, target read) alignment requests:

1. the host routes each request to the chip owning its QUERY read and
   pre-groups it by the chip owning its TARGET read (static capacity
   ``cap`` per (src, dst) pair, mirroring sharded_index's exchange);
   strand-1 gather starts are mirror-adjusted on the host
   (ops.dbgather.gather_offsets semantics);
2. every chip gathers+unpacks its local query windows, re-packs them to
   2-bit + ambiguity bitplanes, and ships them — together with the target
   request fields — to the target owner via one tiled ``all_to_all``;
3. every chip gathers its local target windows and runs the banded Myers
   kernel (ops.device_align._myers_core) on the full received batch;
4. results return to the host sharded by executing chip; the host
   unpermutes them into request order.

Validated against the single-device myers_batch_db on a virtual CPU mesh
(tests/test_sharded.py)."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.device_align import _myers_core
from ..ops.dbgather import (GUARD_BASES, PackedSeqDB, gather_codes,
                            pack_db_np)


@dataclass
class ShardedSeqDB:
    """Read-sharded packed seqdb resident across a mesh."""
    fw: jnp.ndarray          # [D, Rf, 128] 2-bit planes, sharded on dim 0
    amb: jnp.ndarray         # [D, Ra, 128] ambiguity bitplanes
    base: np.ndarray         # [D] base offset where each shard starts
    owner: np.ndarray        # [n_reads] owning chip per read
    read_off: np.ndarray     # [n_reads] absolute read start offsets
    read_len: np.ndarray     # [n_reads] read lengths
    mesh: Mesh
    axis: str


def shard_seqdb(data: np.ndarray, offsets: np.ndarray,
                lengths: np.ndarray, mesh: Mesh,
                axis: str = "data") -> ShardedSeqDB:
    """Split the seqdb into read-aligned shards, packed 2-bit per shard.

    Boundaries fall on read starts rounded down to 1024-base blocks (one
    ambiguity row); shards are padded to a common row count so the
    stacked arrays have one static shape per size class.
    """
    n = mesh.devices.size
    total = len(data)
    n_reads = len(offsets)
    offsets = offsets.astype(np.int64)
    # greedy byte-balanced cuts at read starts, floored to 1024-base
    # blocks; flooring can pull the previous read's tail block into the
    # next shard, so shard segments OVERLAP by up to one read: segment d
    # runs from cut[d] to the start of the first read owned by d+1 (tail
    # bases near a cut are duplicated on both chips — a read never
    # straddles)
    target = total / n
    cut = np.zeros(n + 1, np.int64)
    r = 0
    for d in range(1, n):
        want = int(round(d * target))
        while r < n_reads and offsets[r] < want:
            r += 1
        cut[d] = (int(offsets[r]) >> 10) << 10 if r < n_reads else total
    cut[n] = total
    base = cut[:n].copy()
    # owner d = number of interior cuts <= read offset
    owner = np.searchsorted(cut[1:n], offsets, side="right").astype(np.int32)
    first_of = np.searchsorted(owner, np.arange(n + 1))  # [n+1] read idx
    seg_end = np.where(first_of[1:] < n_reads,
                       offsets[np.minimum(first_of[1:], n_reads - 1)],
                       total)
    fws, ambs = [], []
    for d in range(n):
        fw, ambb = pack_db_np(data[base[d]:seg_end[d]])
        fws.append(fw)
        ambs.append(ambb)
    rf = max(1, max(-(-len(f) // 128) for f in fws))
    rfp = -(-rf // 8192) * 8192   # 1 MB granularity (pow2 over-pads at scale)
    ra = max(1, max(-(-len(a) // 128) for a in ambs))
    rap = -(-ra // 2048) * 2048
    fw_st = np.zeros((n, rfp, 128), np.uint8)
    amb_st = np.zeros((n, rap, 128), np.uint8)
    for d in range(n):
        fw_st[d].reshape(-1)[:len(fws[d])] = fws[d]
        amb_st[d].reshape(-1)[:len(ambs[d])] = ambs[d]
    sh = jax.sharding.NamedSharding(mesh, P(axis, None, None))
    return ShardedSeqDB(fw=jax.device_put(jnp.asarray(fw_st), sh),
                        amb=jax.device_put(jnp.asarray(amb_st), sh),
                        base=base, owner=owner,
                        read_off=np.asarray(offsets, np.int64),
                        read_len=np.asarray(lengths, np.int64),
                        mesh=mesh, axis=axis)


def _pack2(codes: jnp.ndarray):
    """[B, L] u8 codes (0-3 or fill 7) -> ([B, L/4] 2-bit, [B, L/8] amb)."""
    B, L = codes.shape
    amb = (codes >= 4).astype(jnp.uint8)
    c = jnp.where(amb == 1, jnp.uint8(0), codes)
    c4 = c.reshape(B, L // 4, 4)
    packed = (c4[:, :, 0] | (c4[:, :, 1] << 2) | (c4[:, :, 2] << 4)
              | (c4[:, :, 3] << 6))
    a8 = amb.reshape(B, L // 8, 8)
    abits = (a8 << jnp.arange(8, dtype=jnp.uint8)[None, None, :]).sum(
        axis=2, dtype=jnp.uint8)
    return packed, abits


def _unpack2(packed: jnp.ndarray, abits: jnp.ndarray, fill: int = 7):
    B, L4 = packed.shape
    c = jnp.stack([(packed >> (2 * j)) & 3 for j in range(4)],
                  axis=2).reshape(B, 4 * L4)
    a = jnp.stack([(abits >> j) & 1 for j in range(8)],
                  axis=2).reshape(B, 4 * L4)
    return jnp.where(a == 1, jnp.uint8(fill), c.astype(jnp.uint8))


def _exchange_align(fw, amb, qgo, ql, qs, tgo, tl, ts, *, axis: str, n: int,
                    cap: int, L: int, nb: int, unroll: int):
    """shard_map body: local q gather -> 2-bit pack -> all_to_all ->
    local t gather -> Myers.  All request arrays are [1, n*cap] (this
    chip's q-owned requests, grouped [dst, cap]); offsets are shard-local
    gather starts (mirror-adjusted on the host)."""
    pdb = PackedSeqDB(fw=fw[0], amb=amb[0])

    def ex(a):
        # [n*cap,...] grouped by dst -> rows from each src after exchange
        return jax.lax.all_to_all(a.reshape((n, cap) + a.shape[1:]),
                                  axis, 0, 0, tiled=True).reshape(
                                      (n * cap,) + a.shape[1:])

    qc = gather_codes(pdb, qgo[0], ql[0], qs[0], L, fill=7)
    qp, qa = _pack2(qc)
    qc = _unpack2(ex(qp), ex(qa), fill=7)
    ql2 = ex(ql[0])
    tgo2, tl2, ts2 = ex(tgo[0]), ex(tl[0]), ex(ts[0])
    tc = gather_codes(pdb, tgo2, tl2, ts2, L, fill=7)
    d, qe, te = _myers_core(qc, ql2, tc, tl2, nb=nb, unroll=unroll)
    return d[None], qe[None], te[None]


@functools.lru_cache(maxsize=64)
def _build_exchange(mesh: Mesh, axis: str, n: int, cap: int, L: int,
                    nb: int, unroll: int):
    return jax.jit(jax.shard_map(
        functools.partial(_exchange_align, axis=axis, n=n, cap=cap,
                          L=L, nb=nb, unroll=unroll),
        mesh=mesh,
        in_specs=(P(axis, None, None),) * 2 + (P(axis, None),) * 6,
        out_specs=(P(axis, None),) * 3,
        # the Myers kernel's constant initial carries are unvarying while
        # its outputs vary per device; the VMA checker rejects that mix
        check_vma=False))


def sharded_align(sdb: ShardedSeqDB,
                  q_rid: np.ndarray, q_off: np.ndarray, q_len: np.ndarray,
                  q_strand: np.ndarray,
                  t_rid: np.ndarray, t_off: np.ndarray, t_len: np.ndarray,
                  t_strand: np.ndarray, *, L: int, nb: int = 8,
                  unroll: int = 32, cap: int | None = None):
    """Batched banded alignment of (query window, target read) requests
    against the sharded seqdb; returns (dist, q_end, t_end) in request
    order. q_off/t_off are ABSOLUTE offsets into the unsharded db; every
    window must end at its read's end (gather_offsets mirror rule).
    """
    n = sdb.mesh.devices.size
    nreq = len(q_rid)
    src = sdb.owner[q_rid]
    dst = sdb.owner[t_rid]
    # mirror-adjusted gather starts, shard-local
    qgo_abs = np.where(q_strand == 0, q_off,
                       sdb.read_off[q_rid] + q_len - L)
    tgo_abs = np.where(t_strand == 0, t_off, t_off + t_len - L)
    qloc = qgo_abs - sdb.base[src]
    tloc = tgo_abs - sdb.base[dst]

    # slot assignment per (src, dst)
    pair = src.astype(np.int64) * n + dst
    order = np.argsort(pair, kind="stable")
    counts = np.bincount(pair, minlength=n * n)
    need = int(counts.max()) if nreq else 1
    if cap is None:
        cap = 1 << max(5, (need - 1).bit_length())
    if need > cap:
        raise ValueError(f"per-pair capacity {cap} < max group {need}")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.empty(nreq, np.int64)
    slot[order] = np.arange(nreq) - np.repeat(starts, counts)

    def pack(vals, dtype, fill=0):
        a = np.full((n, n * cap), fill, dtype)
        a[src, dst * cap + slot] = vals
        return jnp.asarray(a)

    qgo = pack(qloc, np.int64)
    ql = pack(q_len, np.int32)
    qs = pack(q_strand, np.int32)
    tgo = pack(tloc, np.int64)
    tl = pack(t_len, np.int32)
    ts = pack(t_strand, np.int32)

    fn = _build_exchange(sdb.mesh, sdb.axis, n, cap, L, nb, unroll)
    out = fn(sdb.fw, sdb.amb, qgo, ql, qs, tgo, tl, ts)
    if jax.process_count() > 1:
        # multi-controller: the output shards span processes, so gather
        # the global result to every host (device_get needs addressability)
        from jax.experimental import multihost_utils
        d, qe, te = (np.asarray(multihost_utils.process_allgather(a, tiled=True))
                     for a in out)
    else:
        d, qe, te = jax.device_get(out)
    # request landed on chip dst at flat position src*cap + slot
    sel = (dst, src * cap + slot)
    return d[sel], qe[sel], te[sel]
