"""Batched banded Myers bit-parallel aligner — the device overlap kernel.

Replaces the per-candidate greedy O(ND) walk (reference src/DWmatch.c) with
a bit-parallel banded edit-distance computation vectorized over a batch of
alignments: 32 DP cells per uint32 word, a fixed window of NB word-blocks
sliding along the main diagonal (both sequences are anchored at their
SHIMMER hit, so the optimal path stays near diagonal 0 within the
reference's band tolerance).

Differences vs the reference aligner (validated in tests/test_device_align.py):
  * dist is the *optimal* banded edit distance — consistently lower than
    the greedy walk's overcount, so identity estimates are slightly
    higher; endpoints agree to within a couple of bases;
  * alignment start is the anchor (q_bgn = t_bgn = 0) rather than the
    first 16-base exact run.

All state is uint32; the column loop is a single fused lax.fori_loop, so
one dispatch aligns the whole batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

WB = 32
MSB = jnp.uint32(1 << 31)
FULL = jnp.uint32(0xFFFFFFFF)
BIG = jnp.int32(1 << 30)


def _pack_peq(q_codes: jnp.ndarray, nbq: int) -> jnp.ndarray:
    """[B, LQ] codes -> PEq [B, 4, NBQ] u32 match bitmasks (sentinel-safe)."""
    B, LQ = q_codes.shape
    pad = nbq * WB - LQ
    qc = jnp.pad(q_codes, ((0, 0), (0, pad)), constant_values=7)
    bitpos = jnp.arange(WB, dtype=jnp.uint32)
    blocks = qc.reshape(B, nbq, WB)
    out = []
    for c in range(4):
        bits = (blocks == c).astype(jnp.uint32) << bitpos[None, None, :]
        out.append(bits.sum(axis=2, dtype=jnp.uint32))
    return jnp.stack(out, axis=1)


def _block_update(pv, mv, eq, hin):
    """One Myers block step on [B] u32 lanes; hin/hout in {-1, 0, +1}."""
    xv = eq | mv
    eq = eq | (hin < 0).astype(jnp.uint32)
    xh = (((eq & pv) + pv) ^ pv) | eq
    ph = mv | ~(xh | pv)
    mh = pv & xh
    hout = (jnp.where(ph & MSB, 1, 0) + jnp.where(mh & MSB, -1, 0)).astype(jnp.int32)
    ph = ph << jnp.uint32(1)
    mh = mh << jnp.uint32(1)
    mh = mh | (hin < 0).astype(jnp.uint32)
    ph = ph | (hin > 0).astype(jnp.uint32)
    pv_new = mh | ~(xv | ph)
    mv_new = ph & xv
    return pv_new, mv_new, hout


def _myers_core(q_codes: jnp.ndarray, q_lens: jnp.ndarray,
                t_codes: jnp.ndarray, t_lens: jnp.ndarray, *, nb: int,
                unroll: int):
    """Align a batch of anchored pairs.

    Args:
      q_codes: [B, LQ] uint8 query 2-bit codes (>=4 treated as no-match).
      t_codes: [B, LT] uint8 target codes.
      q_lens/t_lens: [B] int32 true lengths.
      nb: window width in 32-bit blocks (8 -> 256-cell band, covering the
          reference band tolerance of 100; src/shmr_overlap.c:42).

    Returns (dist, q_end, t_end) int32 [B].
    """
    B, LQ = q_codes.shape
    LT = t_codes.shape[1]
    nbq = -(-max(LQ, LT + nb * WB) // WB) + nb + 1
    peq = _pack_peq(q_codes, nbq)          # [B, 4, nbq]
    tc = t_codes.astype(jnp.int32)
    q_lens = q_lens.astype(jnp.int32)
    t_lens = t_lens.astype(jnp.int32)

    pv0 = jnp.full((B, nb), FULL, jnp.uint32)
    mv0 = jnp.zeros((B, nb), jnp.uint32)
    state = dict(
        pv=pv0, mv=mv0,
        bot=jnp.full((B,), nb * WB, jnp.int32),
        best_te_d=jnp.full((B,), BIG, jnp.int32),
        best_te_j=jnp.zeros((B,), jnp.int32),
        snap_pv=pv0, snap_mv=mv0,
        snap_bot=jnp.full((B,), nb * WB, jnp.int32),
        snap_w0=jnp.zeros((B,), jnp.int32),
    )

    # Columns are processed in WB-wide chunks: the band window position
    # w0(j) = max(0, j//WB - nb//2) is constant within a chunk, so the PEq
    # window is sliced once and the WB column updates unroll inside one
    # loop body (cuts loop/dispatch overhead ~WB-fold).
    n_chunks = -(-LT // WB)
    LTP = n_chunks * WB
    tcp = jnp.pad(tc, ((0, 0), (0, LTP - LT)), constant_values=7)

    def body(chunk, st):
        j0 = chunk * WB
        w0 = jnp.maximum(0, chunk - nb // 2)
        w0_prev = jnp.maximum(0, chunk - 1 - nb // 2)
        slide = (w0 > w0_prev) & (chunk > 0)

        pv, mv = st["pv"], st["mv"]
        pv = jnp.where(slide,
                       jnp.concatenate([pv[:, 1:],
                                        jnp.full((B, 1), FULL, jnp.uint32)], 1),
                       pv)
        mv = jnp.where(slide,
                       jnp.concatenate([mv[:, 1:],
                                        jnp.zeros((B, 1), jnp.uint32)], 1), mv)
        bot = st["bot"] + jnp.where(slide, WB, 0)

        cs = jax.lax.dynamic_slice(tcp, (0, j0), (B, WB))        # [B, WB]
        peq_win = [jax.lax.dynamic_slice(peq[:, cc], (0, w0), (B, nb))
                   for cc in range(4)]

        best_te_d = st["best_te_d"]
        best_te_j = st["best_te_j"]
        snap_pv, snap_mv = st["snap_pv"], st["snap_mv"]
        snap_bot, snap_w0 = st["snap_bot"], st["snap_w0"]
        bottom_row = (w0 + nb) * WB
        covers_q = bottom_row >= q_lens

        def col_step(u, carry):
            (pv, mv, bot, best_te_d, best_te_j,
             snap_pv, snap_mv, snap_bot, snap_w0) = carry
            j = j0 + u
            c = jax.lax.dynamic_slice(cs, (0, u), (B, 1))[:, 0]
            eqw = jnp.zeros((B, nb), jnp.uint32)
            for cc in range(4):
                eqw = eqw + jnp.where((c == cc)[:, None], peq_win[cc], 0)

            hin = jnp.ones((B,), jnp.int32)
            outs_pv, outs_mv = [], []
            for b in range(nb):
                p, m, hin = _block_update(pv[:, b], mv[:, b], eqw[:, b], hin)
                outs_pv.append(p)
                outs_mv.append(m)
            pv = jnp.stack(outs_pv, axis=1)
            mv = jnp.stack(outs_mv, axis=1)
            bot = bot + hin

            active = j < t_lens
            d_lq = bot - (bottom_row - q_lens)
            better = active & covers_q & (d_lq < best_te_d)
            best_te_d = jnp.where(better, d_lq, best_te_d)
            best_te_j = jnp.where(better, j + 1, best_te_j)

            is_last = j == (t_lens - 1)
            snap_pv = jnp.where(is_last[:, None], pv, snap_pv)
            snap_mv = jnp.where(is_last[:, None], mv, snap_mv)
            snap_bot = jnp.where(is_last, bot, snap_bot)
            snap_w0 = jnp.where(is_last, w0, snap_w0)
            return (pv, mv, bot, best_te_d, best_te_j,
                    snap_pv, snap_mv, snap_bot, snap_w0)

        carry = (pv, mv, bot, best_te_d, best_te_j,
                 snap_pv, snap_mv, snap_bot, snap_w0)
        if unroll >= WB:
            for u in range(WB):
                carry = col_step(u, carry)
        else:
            carry = jax.lax.fori_loop(0, WB, col_step, carry,
                                      unroll=max(1, unroll))
        (pv, mv, bot, best_te_d, best_te_j,
         snap_pv, snap_mv, snap_bot, snap_w0) = carry

        return dict(pv=pv, mv=mv, bot=bot, best_te_d=best_te_d,
                    best_te_j=best_te_j, snap_pv=snap_pv, snap_mv=snap_mv,
                    snap_bot=snap_bot, snap_w0=snap_w0)

    st = jax.lax.fori_loop(0, n_chunks, body, state)

    # target-end readout: walk scores up the snapshot column
    bits = jnp.arange(nb * WB, dtype=jnp.uint32)
    pv_bits = (st["snap_pv"].reshape(B, -1)[:, bits // WB]
               >> (bits % WB)) & jnp.uint32(1)
    mv_bits = (st["snap_mv"].reshape(B, -1)[:, bits // WB]
               >> (bits % WB)) & jnp.uint32(1)
    delta = pv_bits.astype(jnp.int32) - mv_bits.astype(jnp.int32)   # [B, nb*WB]
    # score at row (bottom - r) = bot - sum of deltas of bits above row
    suffix = jnp.cumsum(delta[:, ::-1], axis=1)                     # r = 1..nb*WB
    rows = (st["snap_w0"] + nb)[:, None] * WB - jnp.arange(1, nb * WB + 1)[None, :]
    scores = st["snap_bot"][:, None] - suffix
    # include the bottom row itself (r = 0)
    rows = jnp.concatenate([((st["snap_w0"] + nb) * WB)[:, None], rows], axis=1)
    scores = jnp.concatenate([st["snap_bot"][:, None], scores], axis=1)
    valid = (rows >= 0) & (rows <= q_lens[:, None])
    scores = jnp.where(valid, scores, BIG)
    qe_idx = jnp.argmin(scores, axis=1)
    best_qe_d = jnp.take_along_axis(scores, qe_idx[:, None], 1)[:, 0]
    best_qe_row = jnp.take_along_axis(rows, qe_idx[:, None], 1)[:, 0]

    use_te = st["best_te_d"] <= best_qe_d
    dist = jnp.where(use_te, st["best_te_d"], best_qe_d)
    q_end = jnp.where(use_te, q_lens, best_qe_row)
    t_end = jnp.where(use_te, st["best_te_j"], t_lens)
    return dist, q_end, t_end


myers_batch = jax.jit(_myers_core, static_argnames=("nb", "unroll"))

# columns unrolled per loop body on an accelerator backend: the fastest of
# {1, 8, 32} timed on the H100 (PERF.md); the CPU backend compiles large
# unrolled bodies slowly, so it keeps the rolled loop
ACCEL_UNROLL = 32


def default_unroll() -> int:
    return 1 if jax.default_backend() == "cpu" else ACCEL_UNROLL


@functools.partial(jax.jit, static_argnames=("L", "nb", "unroll"))
def myers_batch_db_packed(seqdb, cols: jnp.ndarray, *, L: int, nb: int = 8,
                          unroll: int = 32):
    """myers_batch_db with the seven per-request columns packed into ONE
    [B, 7] int64 array (q_off, q_rstart, q_len, q_strand, t_off, t_len,
    t_strand).  One host->device transfer + one dispatch per batch instead
    of seven."""
    return myers_batch_db(
        seqdb, cols[:, 0], cols[:, 1], cols[:, 2].astype(jnp.int32),
        cols[:, 3].astype(jnp.int32), cols[:, 4],
        cols[:, 5].astype(jnp.int32), cols[:, 6].astype(jnp.int32),
        L=L, nb=nb, unroll=unroll)


@functools.partial(jax.jit, static_argnames=("L", "nb", "unroll"))
def myers_batch_db(seqdb,
                   q_off: jnp.ndarray, q_rstart: jnp.ndarray,
                   q_lens: jnp.ndarray, q_strand: jnp.ndarray,
                   t_off: jnp.ndarray, t_lens: jnp.ndarray, t_strand: jnp.ndarray,
                   *, L: int, nb: int = 8, unroll: int = 32):
    """Myers batch with a device-resident 2-bit packed seqdb.

    The packed planes live in device memory once (ops.dbgather.PackedSeqDB
    — the device analog of the reference's shared read-only mmap,
    SURVEY.md §2.3); per
    batch only (offset, length, strand) triplets cross the host link, and
    the code windows are gathered + unpacked on device.  q_rstart is the
    query read's start offset (strand-1 windows gather the mirrored
    forward window; every window ends at its read's end).  Targets are
    whole reads, so their read start IS t_off.
    """
    from .dbgather import gather_codes
    q_off = q_off.astype(jnp.int64)
    t_off = t_off.astype(jnp.int64)
    qgo = jnp.where(q_strand == 0, q_off,
                    q_rstart.astype(jnp.int64) + q_lens - L)
    tgo = jnp.where(t_strand == 0, t_off, t_off + t_lens - L)
    qc = gather_codes(seqdb, qgo, q_lens, q_strand, L, fill=7)
    tc = gather_codes(seqdb, tgo, t_lens, t_strand, L, fill=7)
    return _myers_core(qc, q_lens, tc, t_lens, nb=nb, unroll=unroll)


def myers_batch_np(qs: list[np.ndarray], ts: list[np.ndarray],
                   nb: int = 8, unroll: int | None = None) -> list[tuple[int, int, int]]:
    """Host convenience: pad ragged code lists, run one device batch."""
    B = len(qs)
    LQ = max(len(q) for q in qs)
    LT = max(len(t) for t in ts)
    qc = np.full((B, LQ), 7, np.uint8)
    tc = np.full((B, LT), 7, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i, (q, t) in enumerate(zip(qs, ts)):
        qc[i, :len(q)] = q
        tc[i, :len(t)] = t
        ql[i] = len(q)
        tl[i] = len(t)
    if unroll is None:
        unroll = default_unroll()
    d, qe, te = jax.device_get(
        myers_batch(jnp.asarray(qc), jnp.asarray(ql),
                    jnp.asarray(tc), jnp.asarray(tl), nb=nb, unroll=unroll))
    return list(zip(d.tolist(), qe.tolist(), te.tolist()))
