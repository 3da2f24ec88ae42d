"""Device-resident seqdb: 2-bit packed upload + on-device window gather.

The host seqdb is the reference's 4-bit dual-strand codec (one byte per
base, src/shmr_utils.c:44-62).  On device that byte-per-base layout wastes
HBM and gather bandwidth 4x, so the upload packs two planes:

  * fw:  2-bit forward base codes, 4 bases/byte, [rows, 128] u8;
  * amb: 1-bit ambiguity flags (non-ACGT), 8 bases/byte, [rows, 128] u8.

Reverse-strand windows: the 4-bit codec's high nibble at position a inside
a read [s, s+n) is complement(base[2s+n-1-a]) — reading a window's high
nibbles equals reading the MIRRORED forward window flipped + complemented.
Every consumer window ends at its read's end (overlap queries clip the
query's head, targets are whole reads), so the mirrored gather start is
simply  s + window_len - L  — computed here from the read start, then the
gather flips and complements on device.  A guard region below every
shard/db start keeps mirrored starts of L-padded windows non-negative.

Ambiguous bases decode to the caller's fill code (7 for the aligner: N
matches N and mismatches ACGT, exactly the reference nibble compare in
src/DWmatch.c:135-140; 4 for the sketch's reset semantics).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# guard (in bases) below the packed db start: a strand-1 window of true
# length len padded to L gathers from  start + len - L >= -L, so any
# L <= GUARD_BASES stays in bounds.  Multiple of 1024 (one amb row).
GUARD_BASES = 1 << 16

class PackedSeqDB(NamedTuple):
    """Two-plane packed seqdb (device arrays; a valid jit argument)."""
    fw: jnp.ndarray    # [Rf, 128] u8 — 2-bit codes, 4 bases/byte
    amb: jnp.ndarray   # [Ra, 128] u8 — ambiguity bits, 8 bases/byte


def pack_db_np(data: np.ndarray, guard_bases: int = GUARD_BASES
               ) -> tuple[np.ndarray, np.ndarray]:
    """Host packing: 4-bit codec bytes -> (fw bytes, amb bytes) with the
    guard region prepended.  Returns flat byte arrays (not row-shaped).
    One C++ pass (native/pack2.cpp) — the numpy formulation allocated
    several full-size temporaries."""
    assert guard_bases % 1024 == 0
    from ..native import pack_db
    return pack_db(data, guard_bases)


def _pad_rows(flat: np.ndarray, floor_rows: int) -> np.ndarray:
    """[N] bytes -> [rows, 128] with a bounded set of row counts: pow2
    with 3 mantissa bits (<= 8 shape classes per octave) so dataset size
    does not recompile downstream jits, without pow2's 2x waste."""
    n_rows = max(1, -(-len(flat) // 128))
    if n_rows <= floor_rows:
        rpad = floor_rows
    else:
        unit = max(floor_rows, 1 << max(0, (n_rows - 1).bit_length() - 3))
        rpad = -(-n_rows // unit) * unit
    rows = np.zeros((rpad, 128), np.uint8)
    rows.reshape(-1)[:len(flat)] = flat
    return rows


def _amb_plane(ambb: np.ndarray, floor_rows: int = 1 << 17) -> jnp.ndarray:
    """Ambiguity plane upload with ELISION: reads without a single
    non-ACGT base (simulated data always; HiFi reads usually) make the
    amb bytes all-zero — materialize the plane as device zeros instead
    of shipping ~1 bit/base (a third of the seqdb-plane transfer)."""
    rows = _pad_rows(ambb, floor_rows)
    if not ambb.any():
        return jnp.zeros(rows.shape, jnp.uint8)
    return jnp.asarray(rows)


def upload_seqdb(data: np.ndarray) -> PackedSeqDB:
    """Pack and move the seqdb to device memory (one-time per stage)."""
    fw, ambb = pack_db_np(data)
    return PackedSeqDB(fw=jnp.asarray(_pad_rows(fw, 1 << 19)),
                       amb=_amb_plane(ambb))


class SeqDBUploader:
    """Incremental pack + upload of the 4-bit data plane WHILE the host
    is still producing it, hiding the device transfer under the stage-0
    encode wall.

    feed() takes consecutive byte chunks whose boundaries are multiples
    of 1024 bases (so the 2-bit and ambiguity planes both cut at whole
    128-byte rows); the final chunk may be any length.  Packing and
    device_put run on a worker thread (both release the GIL).  finish()
    joins, concatenates the per-chunk plane pieces on device, pads to
    the _pad_rows shape class, and returns a PackedSeqDB bit-identical
    to upload_seqdb(data) (asserted in tests/test_dbgather.py)."""

    CHUNK_ALIGN = 1024

    def __init__(self):
        import queue
        import threading
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._fw_parts: list = []
        self._amb_parts: list = []
        self._nbases = 0
        self._first = True
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._worker,
                                   name="seqdb-upload", daemon=True)
        self._t.start()

    # device_put pieces are aggregated to this many fw bytes: fewer, larger
    # puts, and a final concat whose operand count (and so its compiled
    # program) does not grow with every 4 MB chunk
    PIECE_FW_BYTES = 256 << 20

    def _flush_piece(self, force: bool) -> None:
        nfw = sum(len(a) for a in self._acc_fw)
        if nfw == 0 or (not force and nfw < self.PIECE_FW_BYTES):
            return
        fw = np.concatenate(self._acc_fw) if len(self._acc_fw) > 1 \
            else self._acc_fw[0]
        amb = np.concatenate(self._acc_amb) if len(self._acc_amb) > 1 \
            else self._acc_amb[0]
        self._acc_fw, self._acc_amb = [], []
        if len(fw) % 128 == 0 and len(amb) % 128 == 0:
            self._fw_parts.append(jnp.asarray(fw.reshape(-1, 128)))
            # amb elision per piece: all-zero ambiguity bytes become
            # device zeros (no transfer, no client staging)
            self._amb_parts.append(
                jnp.zeros((len(amb) // 128, 128), jnp.uint8)
                if not amb.any() else jnp.asarray(amb.reshape(-1, 128)))
        else:  # only the final ragged piece
            self._fw_parts.append(fw)
            self._amb_parts.append(amb)

    def _worker(self):
        self._acc_fw: list = []
        self._acc_amb: list = []
        while True:
            item = self._q.get()
            if item is None:
                try:
                    self._flush_piece(force=True)
                except Exception as e:
                    self._err = e
                return
            try:
                chunk, is_first = item
                guard = GUARD_BASES if is_first else 0
                fw, amb = pack_db_np(chunk, guard)
                self._acc_fw.append(fw)
                self._acc_amb.append(amb)
                self._flush_piece(force=False)
            except Exception as e:  # surfaced by finish()
                self._err = e

    def feed(self, chunk: np.ndarray) -> None:
        """chunk: consecutive 4-bit codec bytes; every call except the
        last must pass a multiple of CHUNK_ALIGN bases."""
        if len(chunk) == 0:
            return
        self._nbases += len(chunk)
        self._q.put((np.asarray(chunk, np.uint8).copy(), self._first))
        self._first = False

    def finish(self) -> PackedSeqDB:
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            raise self._err
        if self._first:  # nothing fed
            return upload_seqdb(np.zeros(0, np.uint8))
        total_fw = (GUARD_BASES + self._nbases + 3) // 4
        total_amb = (GUARD_BASES + self._nbases + 7) // 8
        out = []
        for parts, total, floor in ((self._fw_parts, total_fw, 1 << 19),
                                    (self._amb_parts, total_amb, 1 << 17)):
            # the _pad_rows row count for the full plane
            n_rows = max(1, -(-total // 128))
            if n_rows <= floor:
                rpad = floor
            else:
                unit = max(floor, 1 << max(0, (n_rows - 1).bit_length() - 3))
                rpad = -(-n_rows // unit) * unit
            dev_rows = sum(p.shape[0] for p in parts
                           if not isinstance(p, np.ndarray))
            tail = [p for p in parts if isinstance(p, np.ndarray)]
            assert len(tail) <= 1 and (not tail or parts[-1] is tail[0]), \
                "only the final chunk may be ragged"
            tail_rows = _pad_rows(tail[0], 1)[: -(-len(tail[0]) // 128)] \
                if tail else np.zeros((0, 128), np.uint8)
            pad_rows = rpad - dev_rows - tail_rows.shape[0]
            pieces = [p for p in parts if not isinstance(p, np.ndarray)]
            pieces.append(jnp.asarray(tail_rows))
            pieces.append(jnp.zeros((pad_rows, 128), jnp.uint8))
            out.append(jnp.concatenate(pieces, axis=0))
        return PackedSeqDB(fw=out[0], amb=out[1])


def gather_offsets(off: np.ndarray, lens: np.ndarray, strand: np.ndarray,
                   read_start: np.ndarray, L: int):
    """Host helper: gather start per request.  strand 0 -> window start;
    strand 1 -> mirrored start (windows must end at their read's end)."""
    return np.where(strand == 0, off, read_start + lens - L)


def _gather_bytes(rows: jnp.ndarray, byte0: jnp.ndarray, nbytes: int):
    """[B] byte offsets -> [B, nbytes] bytes via whole-row gather + a
    two-level static-slice select (no element gathers)."""
    n_rows = rows.shape[0]
    B = byte0.shape[0]
    r0 = (byte0 >> 7).astype(jnp.int32)
    nr = (nbytes + 8) // 128 + 2
    ridx = r0[:, None] + jnp.arange(nr, dtype=jnp.int32)[None, :]
    g = jnp.take(rows, jnp.clip(ridx, 0, n_rows - 1), axis=0)
    flat = g.reshape(B, nr * 128)
    s1 = ((byte0 >> 3) & 15).astype(jnp.int32)[:, None]
    cases8 = [flat[:, 8 * i: 8 * i + nbytes + 8] for i in range(16)]
    raw8 = jax.lax.select_n(jnp.broadcast_to(s1, (B, nbytes + 8)), *cases8)
    s2 = (byte0 & 7).astype(jnp.int32)[:, None]
    cases1 = [raw8[:, i: i + nbytes] for i in range(8)]
    return jax.lax.select_n(jnp.broadcast_to(s2, (B, nbytes)), *cases1)


def gather_codes(pdb: PackedSeqDB, goff: jnp.ndarray, lens: jnp.ndarray,
                 strand: jnp.ndarray, L: int, fill: int) -> jnp.ndarray:
    """[B] windows -> [B, L] 2-bit codes (ambiguous/padding = fill).

    goff is the GATHER start from gather_offsets (mirror-adjusted for
    strand 1); strand 1 output is flipped + complemented on device.
    """
    assert L % 8 == 0 and L <= GUARD_BASES
    B = goff.shape[0]
    p = goff + GUARD_BASES

    # code plane: 4 bases/byte
    L4 = L // 4
    cbytes = _gather_bytes(pdb.fw, p >> 2, L4 + 1)
    c4 = jnp.stack([(cbytes >> (2 * j)) & 3 for j in range(4)], axis=2)
    c4 = c4.reshape(B, 4 * (L4 + 1))
    sc = (p & 3).astype(jnp.int32)[:, None]
    ccases = [c4[:, j: j + L] for j in range(4)]
    code = jax.lax.select_n(jnp.broadcast_to(sc, (B, L)), *ccases)

    # ambiguity plane: 8 bases/byte
    L8 = L // 8
    abytes = _gather_bytes(pdb.amb, p >> 3, L8 + 1)
    a8 = jnp.stack([(abytes >> j) & 1 for j in range(8)], axis=2)
    a8 = a8.reshape(B, 8 * (L8 + 1))
    sa = (p & 7).astype(jnp.int32)[:, None]
    acases = [a8[:, j: j + L] for j in range(8)]
    amb = jax.lax.select_n(jnp.broadcast_to(sa, (B, L)), *acases)

    rev = strand[:, None] == 1
    code = jnp.where(rev, jnp.flip(code, axis=1) ^ 3, code)
    amb = jnp.where(rev, jnp.flip(amb, axis=1), amb)

    out = jnp.where(amb == 1, jnp.uint8(fill), code.astype(jnp.uint8))
    inlen = jnp.arange(L)[None, :] < lens[:, None]
    return jnp.where(inlen, out, jnp.uint8(fill))
