import numpy as np
import pytest

from peregrine_tpu.io.seqdb import seq_to_codes
from peregrine_tpu.ops.reduce import reduce_flat_np
from peregrine_tpu.ops.sketch import sketch_reads_np
from tests import oracles
from tests.conftest import random_seq


def _sketch(seqs, w, k):
    pad = max(len(s) for s in seqs)
    codes = np.full((len(seqs), pad), 4, np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = seq_to_codes(s)
        lens[i] = len(s)
    return sketch_reads_np(codes, lens, np.arange(len(seqs), dtype=np.uint32), w, k)


@pytest.mark.parametrize("w,k,r", [(12, 8, 6), (12, 8, 3), (5, 4, 6), (80, 16, 6)])
def test_reduce_matches_oracle(rng, w, k, r):
    seqs = [random_seq(rng, 3000 + 11 * i) for i in range(5)]
    x, y = _sketch(seqs, w, k)
    l0 = list(zip(x.tolist(), y.tolist()))
    want1 = oracles.mm_reduce(l0, r)
    gx, gy = reduce_flat_np(x, y, r)
    got1 = list(zip(gx.tolist(), gy.tolist()))
    assert got1 == want1

    # second level (L2)
    want2 = oracles.mm_reduce(want1, r)
    g2x, g2y = reduce_flat_np(gx, gy, r)
    assert list(zip(g2x.tolist(), g2y.tolist())) == want2


def test_reduce_short_reads(rng):
    # reads yielding fewer than r minimizers produce no output
    seqs = [random_seq(rng, 60), random_seq(rng, 3000)]
    x, y = _sketch(seqs, 12, 8)
    want = oracles.mm_reduce(list(zip(x.tolist(), y.tolist())), 6)
    gx, gy = reduce_flat_np(x, y, 6)
    assert list(zip(gx.tolist(), gy.tolist())) == want


def test_reduce_tie_slot_break(rng):
    # duplicate hashes within a window exercise the ring-slot tiebreak
    x = np.array([(5 << 8) | 16, (5 << 8) | 16, (7 << 8) | 16,
                  (5 << 8) | 16, (9 << 8) | 16], dtype=np.uint64)
    y = np.array([(1 << 32) | (p << 1) for p in (10, 20, 30, 40, 50)],
                 dtype=np.uint64)
    want = oracles.mm_reduce(list(zip(x.tolist(), y.tolist())), 3)
    gx, gy = reduce_flat_np(x, y, 3)
    assert list(zip(gx.tolist(), gy.tolist())) == want


def test_end_filter_matches_reference_semantics(rng):
    """end_filter_np mirrors mm_end_filter's pos/r_pos selection."""
    import numpy as np

    from peregrine_tpu.ops.reduce import end_filter_np

    n = 500
    rlen = np.full(8, 3000, np.int64)
    rid = rng.integers(0, 8, n).astype(np.uint64)
    pos0 = rng.integers(15, 3000, n).astype(np.uint64)  # pos-1 encoding
    strand = rng.integers(0, 2, n).astype(np.uint64)
    span = np.full(n, 16, np.uint64)
    x = (rng.integers(0, 1 << 48, n).astype(np.uint64) << np.uint64(8)) | span
    y = (rid << np.uint64(32)) | ((pos0 - np.uint64(1)) << np.uint64(1)) | strand

    (x5, y5), (x3, y3) = end_filter_np(x, y, rlen, 250)
    pos = pos0.astype(np.int64)
    want5 = pos < 250
    want3 = (3000 - pos + 16) < 250
    assert len(x5) == int(want5.sum())
    assert len(x3) == int(want3.sum())
    np.testing.assert_array_equal(y5, y[want5])
    np.testing.assert_array_equal(y3, y[want3])
