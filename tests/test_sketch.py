import numpy as np
import pytest

from peregrine_tpu.io.seqdb import seq_to_codes
from peregrine_tpu.ops.sketch import sketch_batch, sketch_reads_np, hash64
from tests import oracles
from tests.conftest import random_seq

import jax.numpy as jnp


def test_hash64_matches_oracle(rng):
    mask = (1 << 32) - 1
    keys = rng.integers(0, mask, size=100, dtype=np.uint64)
    got = np.asarray(hash64(jnp.asarray(keys), jnp.uint64(mask)))
    want = np.array([oracles.hash64(int(x), mask) for x in keys], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)
    mask56 = (1 << 56) - 1
    keys = rng.integers(0, mask56, size=100, dtype=np.uint64)
    got = np.asarray(hash64(jnp.asarray(keys), jnp.uint64(mask56)))
    want = np.array([oracles.hash64(int(x), mask56) for x in keys], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def _run_batch(seqs, w, k, pad=None):
    pad = pad or max(len(s) for s in seqs)
    B = len(seqs)
    codes = np.full((B, pad), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = seq_to_codes(s)
        lens[i] = len(s)
    rids = np.arange(B, dtype=np.uint32)
    x, y = sketch_reads_np(codes, lens, rids, w, k)
    return list(zip(x.tolist(), y.tolist()))


@pytest.mark.parametrize("w,k,n", [(80, 16, 2000), (80, 16, 500),
                                   (12, 8, 777), (24, 12, 1200)])
def test_sketch_matches_oracle_clean(rng, w, k, n):
    # k >= 8: hash ties within a window are vanishingly rare, so the
    # emission set equals the reference's sequential output exactly
    seqs = [random_seq(rng, n + 17 * i) for i in range(4)]
    got = _run_batch(seqs, w, k)
    want = []
    for rid, s in enumerate(seqs):
        want.extend(oracles.mm_sketch(s, w, k, rid))
    assert got == want


def test_sketch_tiny_k_superset(rng):
    # k=4 on random sequences hits first-complete-window hash ties; the
    # documented divergence makes the output a superset (order preserved)
    seqs = [random_seq(rng, 300 + 17 * i) for i in range(4)]
    got = _run_batch(seqs, 5, 4)
    want = []
    for rid, s in enumerate(seqs):
        want.extend(oracles.mm_sketch(s, 5, 4, rid))
    got_set = set(got)
    assert all(t in got_set for t in want)
    want_set = set(want)
    assert [t for t in got if t in want_set] == want


def test_sketch_short_reads(rng):
    # shorter than w+k-1: only the final held minimum is emitted
    seqs = [random_seq(rng, 40), random_seq(rng, 90), random_seq(rng, 17)]
    got = _run_batch(seqs, 80, 16, pad=128)
    want = []
    for rid, s in enumerate(seqs):
        want.extend(oracles.mm_sketch(s, 80, 16, rid))
    assert got == want


def test_sketch_tiny_wk(rng):
    # Small w,k with periodic sequences create dense hash ties.  The
    # reference's sequential algorithm drops a tie-element exactly at the
    # first-complete-window boundary (supersede guard l >= w+k fires one
    # step after the l == w+k-1 special case); the declarative emission-set
    # implementation keeps it.  Assert superset + order preservation.
    seqs = [b"ACGT" * 100, b"AAAACCCCGGGGTTTT" * 20, random_seq(rng, 256)]
    got = _run_batch(seqs, 5, 4, pad=512)
    want = []
    for rid, s in enumerate(seqs):
        want.extend(oracles.mm_sketch(s, 5, 4, rid))
    got_set = set(got)
    assert all(t in got_set for t in want)
    want_set = set(want)
    assert [t for t in got if t in want_set] == want
    assert len(got) - len(want) <= len(seqs)


def test_sketch_with_ambiguous_superset(rng):
    # with N's the implementation may emit a superset near resets; every
    # oracle emission must be present, order preserved for common entries
    seqs = [random_seq(rng, 1500, with_n=True) for _ in range(3)]
    got = _run_batch(seqs, 12, 8)
    want = []
    for rid, s in enumerate(seqs):
        want.extend(oracles.mm_sketch(s, 12, 8, rid))
    got_set = set(got)
    missing = [t for t in want if t not in got_set]
    assert not missing
    # order of the oracle subsequence is preserved
    want_set = set(want)
    filtered = [t for t in got if t in want_set]
    assert filtered == want


def test_sketch_position_strand_encoding(rng):
    seq = random_seq(rng, 3000)
    out = _run_batch([seq], 80, 16)
    assert len(out) > 0
    for x, y in out:
        assert (x & 0xFF) == 16          # span
        assert (y >> 32) == 0            # rid
        pos = (y & 0xFFFFFFFF) >> 1
        assert 15 <= pos < len(seq)


def test_sketch_long_matches_single_shot(rng):
    from peregrine_tpu.ops.sketch import sketch_long_np
    seq = random_seq(rng, 200_000)
    codes = seq_to_codes(seq)
    # single shot
    import jax
    import jax.numpy as jnp
    from peregrine_tpu.ops.sketch import sketch_batch
    pad = 1 << 18
    batch = np.full((1, pad), 4, np.uint8)
    batch[0, :len(codes)] = codes
    x, y, c = jax.device_get(sketch_batch(
        jnp.asarray(batch), jnp.asarray([len(codes)], np.int32),
        jnp.asarray([7], np.uint32), w=80, k=16))
    want = list(zip(x[0, :c[0]].tolist(), y[0, :c[0]].tolist()))
    gx, gy = sketch_long_np(codes, 7, 80, 16, seg=1 << 15, margin=1 << 12)
    got = list(zip(gx.tolist(), gy.tolist()))
    assert got == want


def test_shift_compact_matches_sort_compact(rng):
    from peregrine_tpu.ops.sketch import _shift_compact, _sort_compact, INF
    import jax.numpy as jnp

    for B, L, p in ((8, 512, 0.97), (4, 1024, 0.03), (3, 64, 0.5),
                    (2, 128, 0.0), (2, 128, 1.0)):
        keep = rng.random((B, L)) < p
        vals = rng.integers(0, 2**63, (B, L)).astype(np.uint64)
        vals = np.where(keep, vals, np.uint64(0xFFFFFFFFFFFFFFFF))
        aux = rng.integers(0, 100, (B, L)).astype(np.int32)
        aux = np.where(keep, aux, 0)
        k = jnp.asarray(keep)
        (sv, sa), sn = _sort_compact(k, [jnp.asarray(vals), jnp.asarray(aux)])
        (hv, ha), hn = _shift_compact(k, [jnp.asarray(vals), jnp.asarray(aux)],
                                      fills=[INF, jnp.int32(0)])
        np.testing.assert_array_equal(np.asarray(sn), np.asarray(hn))
        np.testing.assert_array_equal(np.asarray(sv), np.asarray(hv))
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(ha))


def test_sketch_long_cap_overflow_fallback(rng):
    """A dense sketch (tiny w) overflows the capped device fetch; the
    uncapped refetch path must still return the exact emission set."""
    from peregrine_tpu.ops.sketch import sketch_batch, sketch_long_np
    import jax
    import jax.numpy as jnp

    seq = random_seq(rng, 100_000)
    codes = seq_to_codes(seq)
    # w=3: density ~2/(w+1) = 0.5 per base >> cap (= pad/8)
    pad = 1 << 17
    batch = np.full((1, pad), 4, np.uint8)
    batch[0, :len(codes)] = codes
    x, y, c = jax.device_get(sketch_batch(
        jnp.asarray(batch), jnp.asarray([len(codes)], np.int32),
        jnp.asarray([3], np.uint32), w=3, k=12))
    want = list(zip(x[0, :c[0]].tolist(), y[0, :c[0]].tolist()))
    assert c[0] > pad // 8  # the test must actually overflow the cap
    gx, gy = sketch_long_np(codes, 3, 3, 12, seg=1 << 15, margin=1 << 12)
    got = list(zip(gx.tolist(), gy.tolist()))
    assert got == want
