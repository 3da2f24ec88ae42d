"""SHIMMER index build — batched device sketch/reduce + sorted-array counts.

Replaces the reference's per-chunk shmr_index process (src/shmr_index.c:37-245):
reads are bucketed by padded length, sketched and hierarchically reduced on
device in batches, and the resulting (x, y) records concatenated in rid
order.  Minimizer multiplicities become sorted (hash, count) arrays instead
of a khash (src/shmr_utils.c:131-160) — lookups are vectorized
searchsorted, merging across shards is a concatenate-and-segment-sum.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AsmConfig
from ..io import formats
from ..io.seqdb import SeqDB
from .reduce import reduce_impl
from .sketch import sketch_impl

_INF = np.uint64(0xFFFFFFFFFFFFFFFF)


@functools.partial(jax.jit,
                   static_argnames=("L", "w", "k", "r", "levels", "cap",
                                    "tight_out"))
def index_step_db(seqdb_rows, offsets, lengths, rids, *, L: int, w: int,
                  k: int, r: int, levels: int, cap: int = 0,
                  tight_out: bool = True):
    """index_step against a device-resident seqdb: per batch only
    (offset, length, rid) triplets cross the host link; the code windows
    are gathered + nibble-decoded on device (ops.dbgather)."""
    from .dbgather import gather_codes
    codes = gather_codes(seqdb_rows, offsets.astype(jnp.int64), lengths,
                         jnp.zeros_like(lengths), L, fill=4)
    return index_step(codes, lengths, rids, w=w, k=k, r=r, levels=levels,
                      cap=cap, tight_out=tight_out)


@functools.partial(jax.jit,
                   static_argnames=("L", "w", "k", "r", "levels", "cap"))
def index_step_db_meta(seqdb_rows, meta, *, L: int, w: int, k: int, r: int,
                       levels: int, cap: int = 0):
    """index_step_db with the per-batch (offset, length, rid) columns
    packed into ONE [B, 3] int64 array: a single host->device transfer
    per dispatch instead of three."""
    return index_step_db(seqdb_rows, meta[:, 0],
                         meta[:, 1].astype(jnp.int32),
                         meta[:, 2].astype(jnp.uint32),
                         L=L, w=w, k=k, r=r, levels=levels, cap=cap)


INDEX_SCAN_GROUP = 16  # batches per scanned dispatch (fixed: stable shapes)


@jax.jit
def _compact_drain(x, y, c):
    """Flatten padded [..., B, C] record planes and stable-sort the valid
    entries to the front, preserving (batch, slot) order — so the host
    fetches only the tight record bytes instead of the padded planes.
    Returns (x_flat, y_flat, n_valid)."""
    C = x.shape[-1]
    xf = x.reshape(-1)
    yf = y.reshape(-1)
    cf = c.reshape(-1).astype(jnp.int32)
    slot = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1).reshape(-1)
    valid = slot < jnp.repeat(cf, C)
    inval = (~valid).astype(jnp.uint32)
    _, xs_, ys_ = jax.lax.sort((inval, xf, yf), num_keys=1, is_stable=True)
    return xs_, ys_, valid.sum()


@functools.partial(jax.jit,
                   static_argnames=("L", "w", "k", "r", "levels", "cap"))
def index_step_db_scan(seqdb_rows, metas, *, L: int, w: int, k: int, r: int,
                       levels: int, cap: int = 0):
    """INDEX_SCAN_GROUP batches in ONE dispatch: metas is
    [G, B, 3] int64 and the batches run as a lax.scan on device — one
    host->device round trip and one result handle per G batches instead
    of per batch.  G is fixed so each (L, B) pad class compiles exactly
    one scan shape regardless of dataset size."""
    def body(_, meta):
        x, y, c, c0 = index_step_db(seqdb_rows, meta[:, 0],
                                    meta[:, 1].astype(jnp.int32),
                                    meta[:, 2].astype(jnp.uint32),
                                    L=L, w=w, k=k, r=r, levels=levels,
                                    cap=cap)
        return 0, (x, y, c, c0)
    _, outs = jax.lax.scan(body, 0, metas)
    return outs


@functools.partial(jax.jit, static_argnames=("w", "k", "r", "levels", "cap", "tight_out"))
def index_step(codes, lengths, rids, *, w: int, k: int, r: int,
               levels: int, cap: int = 0, tight_out: bool = True):
    """Fused device step: sketch -> L1 -> ... -> L_levels in one dispatch.

    cap > 0 statically truncates the minimizer axis after sketching — the
    expected density is 2/(w+1) so cap ~ L/8 is generous; callers must
    check the returned sketch counts against cap (an exact count is
    returned, so overflow is detectable and the batch can be re-run with
    cap=0).

    Returns (x, y, count) of the final level plus the L0 count.
    """
    x, y, c0 = sketch_impl(codes, lengths, rids, w=w, k=k)
    if cap and cap < x.shape[1]:
        x, y = x[:, :cap], y[:, :cap]
    c = jnp.minimum(c0, x.shape[1])
    for _ in range(levels):
        x, y, c = reduce_impl(x, y, c, r=r)
    if levels > 0 and cap and tight_out:
        # each reduction level shrinks the list ~(r/2)x in practice (dedup
        # keeps more than 1/r); slice conservatively so the host pulls a
        # fraction of the padded buffer (c stays exact for overflow checks)
        shrink = max(1, int((r / 2) ** levels))
        out_cap = max(64, cap // shrink)
        if out_cap < x.shape[1]:
            x, y = x[:, :out_cap], y[:, :out_cap]
    return x, y, c, c0


@dataclass
class ShimmerIndex:
    """Final-level SHIMMER records (rid-ordered) + global hash counts."""

    x: np.ndarray           # uint64 [N] hash<<8|span
    y: np.ndarray           # uint64 [N] rid<<32|pos<<1|strand
    mc_hash: np.ndarray     # uint64 [M] sorted distinct hashes
    mc_count: np.ndarray    # uint32 [M] multiplicities

    def counts_for(self, hashes: np.ndarray) -> np.ndarray:
        """Vectorized multiplicity lookup (0 for unseen hashes)."""
        idx = np.searchsorted(self.mc_hash, hashes)
        idx_c = np.minimum(idx, len(self.mc_hash) - 1) if len(self.mc_hash) else idx * 0
        hit = (len(self.mc_hash) > 0) & (self.mc_hash[idx_c] == hashes)
        return np.where(hit, self.mc_count[idx_c], 0).astype(np.uint32)

    # --- reference-format io -------------------------------------------
    def save(self, prefix: str, level: int, chunk: int = 1, total: int = 1) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
        formats.write_mmlist(f"{prefix}-L{level}-{chunk:02d}-of-{total:02d}.dat",
                             self.x, self.y)
        formats.write_mm_count(f"{prefix}-L{level}-MC-{chunk:02d}-of-{total:02d}.dat",
                               self.mc_hash, self.mc_count)

    @classmethod
    def load_chunks(cls, paths_mm: list[str], paths_mc: list[str]) -> "ShimmerIndex":
        xs, ys = zip(*(formats.read_mmlist(p) for p in paths_mm))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        hs, cs = [], []
        for p in paths_mc:
            h, c = formats.read_mm_count(p)
            hs.append(h)
            cs.append(c)
        mh, mc = _merge_counts(np.concatenate(hs), np.concatenate(cs))
        return cls(x, y, mh, mc)


def _merge_counts(hashes: np.ndarray, counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    if len(hashes) == 0:
        return hashes.astype(np.uint64), counts.astype(np.uint32)
    order = np.argsort(hashes, kind="stable")
    h = hashes[order]
    c = counts[order]
    uniq, start = np.unique(h, return_index=True)
    sums = np.add.reduceat(c.astype(np.uint64), start)
    return uniq, sums.astype(np.uint32)


def _length_buckets(lengths: np.ndarray, unit: int) -> dict[int, np.ndarray]:
    pads = np.maximum(1, -(-lengths // unit)) * unit
    out: dict[int, np.ndarray] = {}
    for p in np.unique(pads):
        out[int(p)] = np.flatnonzero(pads == p)
    return out


def build_index_segmented(db: SeqDB, cfg: AsmConfig, budget_bytes: int,
                          keep_l0: bool = False):
    """build_index in contiguous read segments whose packed bytes fit a
    device-memory budget: each segment uploads only its byte window,
    indexes, and frees before the next.  Per-read records are
    independent of batching, so the concatenated result is
    byte-identical to one build (tests/test_index.py)."""
    assert not keep_l0, "segmented build supports the production path only"
    n = len(db)
    groups: list[np.ndarray] = []
    start = 0
    while start < n:
        end = start
        base = int(db.offsets[start])
        while end < n and int(db.offsets[end] + db.lengths[end]) - base \
                <= budget_bytes:
            end += 1
        if end == start:
            end = start + 1  # single read larger than the budget
        groups.append(np.arange(start, end))
        start = end

    xs, ys = [], []
    for g in groups:
        lo = int(db.offsets[g[0]])
        hi = int(db.offsets[g[-1]] + db.lengths[g[-1]])
        part = build_index(db, cfg, rid_filter=g, db_window=(lo, hi))
        xs.append(part.x)
        ys.append(part.y)
    x = np.concatenate(xs) if xs else np.zeros(0, np.uint64)
    y = np.concatenate(ys) if ys else np.zeros(0, np.uint64)
    mh, mc = _merge_counts(x >> np.uint64(8), np.ones(len(x), np.uint32))
    return ShimmerIndex(x, y, mh, mc)


def build_index(db: SeqDB, cfg: AsmConfig, rid_filter: np.ndarray | None = None,
                keep_l0: bool = False, seqdb_rows=None,
                db_window: tuple[int, int] | None = None):
    """Build the final-level SHIMMER index for (a subset of) a SeqDB.

    Mirrors shmr_index semantics (sketch -> r-reduce x levels, counts of the
    final level; src/shmr_index.c:155-233) with device-batched execution.

    Returns a ShimmerIndex (plus the L0 index when keep_l0).
    """
    rids_all = np.arange(len(db)) if rid_filter is None else np.asarray(rid_filter)
    lengths = db.lengths[rids_all].astype(np.int64)
    xs: dict[int, np.ndarray] = {}
    ys: dict[int, np.ndarray] = {}
    l0xs: dict[int, np.ndarray] = {}
    l0ys: dict[int, np.ndarray] = {}

    def _retry_exact(part, pad):
        """Host slow path for (rare) drain-cap overflows: recompute the
        batch with no cap and take exact per-read slices."""
        codes, lens = db.padded_code_batch(part, pad)
        xl, yl, cl, _ = jax.device_get(index_step(
            jnp.asarray(codes), jnp.asarray(lens),
            jnp.asarray(part.astype(np.uint32)),
            w=cfg.w, k=cfg.k, r=cfg.r, levels=cfg.levels, cap=0))
        for b, rid in enumerate(part):
            xs[rid] = xl[b, :cl[b]].copy()
            ys[rid] = yl[b, :cl[b]].copy()

    def _drain(part, handles, pad, fetched=False):
        if keep_l0:
            xl, yl, cl, x0, y0, c0 = jax.device_get(handles)
        else:
            cap = max(256, pad // 8)
            xl, yl, cl, c0 = handles if fetched else jax.device_get(handles)
            if (c0 > cap).any() or (cl > xl.shape[1]).any():
                return _retry_exact(part, pad)
        for b, rid in enumerate(part):
            # .copy(): a bare slice is a VIEW that pins the whole padded
            # [B, cap] drain buffer — holding views for every batch kept
            # ~4x the tight record bytes alive (32 GB peak RSS at 500 Mb
            # scale); copies free each buffer as soon as it is sliced
            xs[rid] = xl[b, :cl[b]].copy()
            ys[rid] = yl[b, :cl[b]].copy()
            if keep_l0:
                l0xs[rid] = x0[b, :c0[b]].copy()
                l0ys[rid] = y0[b, :c0[b]].copy()

    # long sequences (contigs/references) go through the fixed-shape
    # segmented path: one kernel shape regardless of sequence length.
    # The threshold is the pad length itself, so every device pad class
    # stays at or below sketch_pad_len
    long_thresh = cfg.sketch_pad_len
    long_sel = lengths > long_thresh
    if long_sel.any():
        import concurrent.futures as cf

        from .reduce import reduce_flat_np
        from .sketch import sketch_long_np

        def _long_one(rid):
            lx, ly = sketch_long_np(db.codes(rid), int(rid), cfg.w, cfg.k,
                                    seg=cfg.sketch_pad_len)
            l0 = (lx, ly) if keep_l0 else None
            for _ in range(cfg.levels):
                lx, ly = reduce_flat_np(lx, ly, cfg.r)
            return rid, lx, ly, l0

        long_rids = rids_all[long_sel]
        # contig-parallel: the numpy bulk releases the GIL, so threads
        # roughly halve the 24 x 125 Mb contig-sketch wall of stage 4
        # at the human-class rung (~250 s single-threaded)
        if len(long_rids) > 1 and (os.cpu_count() or 1) > 1:
            with cf.ThreadPoolExecutor(os.cpu_count() or 1) as ex:
                results = list(ex.map(_long_one, long_rids))
        else:
            results = [_long_one(rid) for rid in long_rids]
        for rid, lx, ly, l0 in results:
            if keep_l0:
                l0xs[rid], l0ys[rid] = l0
            xs[rid], ys[rid] = lx, ly
        rids_all = rids_all[~long_sel]
        lengths = lengths[~long_sel]

    # dispatch asynchronously against the device-resident seqdb: per batch
    # only offset/length/rid triplets cross the host link; ALL batches are
    # dispatched before any result is read, and the results come back in
    # bulk device_gets instead of one host sync per batch
    from .dbgather import upload_seqdb
    inflight: list = []
    win_lo = 0
    if db_window is not None:
        # upload only this byte window (build_index_segmented): dispatch
        # metas become window-relative
        win_lo = int(db_window[0])
        if seqdb_rows is None and len(rids_all) and not keep_l0:
            seqdb_rows = upload_seqdb(
                np.asarray(db.data[win_lo:int(db_window[1])]))
    elif len(rids_all) and not keep_l0 and seqdb_rows is None:
        # seqdb_rows may be pre-uploaded by the stage-0 background
        # uploader (ops.dbgather.SeqDBUploader), hiding the transfer
        # under the encode wall
        seqdb_rows = upload_seqdb(db.data)

    # bucket unit finer than the max pad: 15 kb HiFi reads at a 32k unit
    # sketched (and fetched) at 2x their length; a 4x finer unit keeps the
    # compile-shape set small (multiples of 8k) while batches stay tight
    bucket_unit = max(2048, cfg.sketch_pad_len // 4)

    def _meta_for(part: np.ndarray, bsz: int) -> np.ndarray:
        meta = np.zeros((bsz, 3), np.int64)
        meta[:len(part), 0] = db.offsets[part] - win_lo
        meta[:len(part), 1] = db.lengths[part]
        meta[:len(part), 2] = part
        return meta

    for pad, sel in _length_buckets(lengths, bucket_unit).items():
        batch_rids = rids_all[sel]
        bsz = max(1, min(cfg.sketch_batch, (cfg.sketch_batch * cfg.sketch_pad_len) // pad))
        cap = max(256, pad // 8)
        parts = [batch_rids[i:i + bsz]
                 for i in range(0, len(batch_rids), bsz)]
        if keep_l0:
            for part in parts:
                from .reduce import reduce_batch
                from .sketch import sketch_batch
                codes, lens = db.padded_code_batch(part, pad)
                args = (jnp.asarray(codes), jnp.asarray(lens),
                        jnp.asarray(part.astype(np.uint32)))
                x0, y0, c0 = sketch_batch(*args, w=cfg.w, k=cfg.k)
                xl, yl, cl = x0, y0, c0
                for _ in range(cfg.levels):
                    xl, yl, cl = reduce_batch(xl, yl, cl, r=cfg.r)
                inflight.append(([part], (xl, yl, cl, x0, y0, c0), pad))
            continue
        # full scan groups go out as ONE dispatch of G batches; the
        # remainder dispatches per batch (index_step_db_meta).  Each
        # dispatch's padded [.., B, C] output planes are immediately
        # compacted ON DEVICE (_compact_drain: one stable sort by
        # validity) so the drain transfers only the ~tight record bytes
        # instead of the padded planes.
        G = INDEX_SCAN_GROUP
        i = 0
        while i + G <= len(parts):
            grp = parts[i:i + G]
            metas = np.stack([_meta_for(p, bsz) for p in grp])
            xl, yl, cl, c0 = index_step_db_scan(
                seqdb_rows, jnp.asarray(metas), L=pad, w=cfg.w, k=cfg.k,
                r=cfg.r, levels=cfg.levels, cap=cap)
            inflight.append((grp, _compact_drain(xl, yl, cl) + (cl, c0),
                             pad, int(xl.shape[-1])))
            i += G
        for part in parts[i:]:
            xl, yl, cl, c0 = index_step_db_meta(
                seqdb_rows, jnp.asarray(_meta_for(part, bsz)), L=pad,
                w=cfg.w, k=cfg.k, r=cfg.r, levels=cfg.levels, cap=cap)
            inflight.append(([part], _compact_drain(xl, yl, cl) + (cl, c0),
                             pad, int(xl.shape[-1])))
    if keep_l0:
        for grp, handles, pad in inflight:
            _drain(grp[0], handles, pad)
    elif inflight:
        # two-phase grouped fetch: counts first (tiny), then only the
        # valid prefix of each compacted stream — one pair of host syncs
        # per ~64 dispatches, transient buffers ~tight bytes
        group = 64
        for lo in range(0, len(inflight), group):
            part_inflight = inflight[lo:lo + group]
            small = jax.device_get(
                [(h[2], h[3], h[4]) for _, h, _, _ in part_inflight])
            big = jax.device_get(
                [(h[0][:int(t)], h[1][:int(t)])
                 for (_, h, _, _), (t, _, _) in zip(part_inflight, small)])
            for (grp, _, pad, C), (tot, cl, c0), (xf, yf) in zip(
                    part_inflight, small, big):
                cap = max(256, pad // 8)
                clf = cl.reshape(-1)
                if (c0 > cap).any() or (clf > C).any():
                    for part in grp:
                        _retry_exact(part, pad)
                    continue
                offs = np.zeros(len(clf) + 1, np.int64)
                np.cumsum(clf, out=offs[1:])
                parts_flat = np.concatenate(grp)
                for b, rid in enumerate(parts_flat):
                    xs[rid] = xf[offs[b]:offs[b + 1]].copy()
                    ys[rid] = yf[offs[b]:offs[b + 1]].copy()

    order = sorted(xs)
    x = np.concatenate([xs[r] for r in order]) if order else np.zeros(0, np.uint64)
    y = np.concatenate([ys[r] for r in order]) if order else np.zeros(0, np.uint64)
    mh, mc = _merge_counts(x >> np.uint64(8),
                           np.ones(len(x), np.uint32))
    idx = ShimmerIndex(x, y, mh, mc)
    if keep_l0:
        lx = np.concatenate([l0xs[r] for r in order]) if order else np.zeros(0, np.uint64)
        ly = np.concatenate([l0ys[r] for r in order]) if order else np.zeros(0, np.uint64)
        mh0, mc0 = _merge_counts(lx >> np.uint64(8), np.ones(len(lx), np.uint32))
        return idx, ShimmerIndex(lx, ly, mh0, mc0)
    return idx
