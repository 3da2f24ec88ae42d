import numpy as np

from peregrine_tpu.config import AsmConfig
from peregrine_tpu.io import formats
from peregrine_tpu.io.seqdb import SeqDB
from peregrine_tpu.ops.index import ShimmerIndex, build_index
from tests import oracles
from tests.conftest import random_seq


def _cfg():
    return AsmConfig(k=8, w=12, r=4, levels=2, sketch_pad_len=1024, sketch_batch=8)


def test_build_index_matches_oracle(rng):
    cfg = _cfg()
    reads = [(f"r{i}", random_seq(rng, int(rng.integers(800, 3000))))
             for i in range(12)]
    db = SeqDB.from_reads(reads)
    idx = build_index(db, cfg)

    want = []
    for rid, (_, s) in enumerate(reads):
        l0 = oracles.mm_sketch(s, cfg.w, cfg.k, rid)
        l1 = oracles.mm_reduce(l0, cfg.r)
        want.extend(oracles.mm_reduce(l1, cfg.r))
    got = list(zip(idx.x.tolist(), idx.y.tolist()))
    assert got == want

    # counts: multiplicity of each final-level hash
    from collections import Counter
    cnt = Counter(x >> 8 for x, _ in want)
    assert dict(zip(idx.mc_hash.tolist(), idx.mc_count.tolist())) == dict(cnt)
    # vectorized lookup
    probe = np.array(list(cnt)[:5] + [123456789], dtype=np.uint64)
    got_c = idx.counts_for(probe)
    want_c = [cnt.get(int(h), 0) for h in probe]
    assert got_c.tolist() == want_c


def test_formats_roundtrip(tmp_path, rng):
    x = rng.integers(0, 1 << 62, 100).astype(np.uint64)
    y = rng.integers(0, 1 << 62, 100).astype(np.uint64)
    p = str(tmp_path / "t.dat")
    formats.write_mmlist(p, x, y)
    x2, y2 = formats.read_mmlist(p)
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(y, y2)
    # 16-byte records + 8-byte header, mm_count padded to 16 as in C
    assert (tmp_path / "t.dat").stat().st_size == 8 + 1600
    formats.write_mm_count(p, x, y.astype(np.uint32))
    h, c = formats.read_mm_count(p)
    np.testing.assert_array_equal(h, x)
    np.testing.assert_array_equal(c, y.astype(np.uint32))
    assert (tmp_path / "t.dat").stat().st_size == 8 + 1600


def test_index_save_load_chunks(tmp_path, rng):
    cfg = _cfg()
    reads = [(f"r{i}", random_seq(rng, 1500)) for i in range(8)]
    db = SeqDB.from_reads(reads)
    # two chunks: rid % 2 == c % 2  (reference chunking, src/shmr_index.c:157)
    paths_mm, paths_mc = [], []
    for c in (1, 2):
        sel = np.flatnonzero(np.arange(len(db)) % 2 == c % 2)
        part = build_index(db, cfg, rid_filter=sel)
        part.save(str(tmp_path / "shmr"), level=2, chunk=c, total=2)
        paths_mm.append(str(tmp_path / f"shmr-L2-{c:02d}-of-02.dat"))
        paths_mc.append(str(tmp_path / f"shmr-L2-MC-{c:02d}-of-02.dat"))
    merged = ShimmerIndex.load_chunks(paths_mm, paths_mc)

    full = build_index(db, cfg)
    # same record multiset and identical merged counts
    assert sorted(zip(merged.x.tolist(), merged.y.tolist())) == \
        sorted(zip(full.x.tolist(), full.y.tolist()))
    np.testing.assert_array_equal(merged.mc_hash, full.mc_hash)
    np.testing.assert_array_equal(merged.mc_count, full.mc_count)


def test_build_index_cap_overflow_refetch(rng):
    """Dense sketches (tiny w) overflow the capped per-batch fetch;
    build_index must detect it via the exact counts and refetch uncapped."""
    from tests.simdata import random_genome, simulate_reads

    cfg = AsmConfig(k=12, w=3, r=4, levels=1, sketch_pad_len=4096,
                    sketch_batch=16)
    genome = random_genome(rng, 20000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=6.0)
    db = SeqDB.from_reads(reads)
    idx = build_index(db, cfg)

    # oracle: uncapped single batch through the same kernel
    import jax
    import jax.numpy as jnp
    from peregrine_tpu.ops.index import index_step
    pad = 4096
    codes, lens = db.padded_code_batch(range(len(db)), pad)
    x, y, c, c0 = jax.device_get(index_step(
        jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(np.arange(len(db), dtype=np.uint32)),
        w=cfg.w, k=cfg.k, r=cfg.r, levels=cfg.levels, cap=0))
    assert (np.asarray(c0) > max(256, pad // 8)).any()  # must overflow
    want_x = np.concatenate([x[b, :c[b]] for b in range(len(db))])
    want_y = np.concatenate([y[b, :c[b]] for b in range(len(db))])
    np.testing.assert_array_equal(idx.x, want_x)
    np.testing.assert_array_equal(idx.y, want_y)


def test_build_index_scan_grouped_batches(rng):
    """The scan-grouped dispatch path (>= INDEX_SCAN_GROUP batches per pad
    class) produces the same records as per-batch dispatch — batching is
    an execution detail."""
    from peregrine_tpu.config import AsmConfig
    from peregrine_tpu.io.seqdb import SeqDB
    from peregrine_tpu.ops.index import INDEX_SCAN_GROUP, build_index
    from tests.simdata import random_genome, simulate_reads

    genome = random_genome(rng, 40000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=8.0)
    assert len(reads) > 2 * INDEX_SCAN_GROUP  # forces >= 1 full scan group
    db = SeqDB.from_reads(reads)
    small = build_index(db, AsmConfig(k=12, w=24, r=4, levels=2,
                                      sketch_pad_len=8192, sketch_batch=2))
    big = build_index(db, AsmConfig(k=12, w=24, r=4, levels=2,
                                    sketch_pad_len=8192, sketch_batch=64))
    np.testing.assert_array_equal(small.x, big.x)
    np.testing.assert_array_equal(small.y, big.y)
    np.testing.assert_array_equal(small.mc_hash, big.mc_hash)
    np.testing.assert_array_equal(small.mc_count, big.mc_count)


def test_segmented_build_matches_full(rng):
    """build_index_segmented (device-memory-budget read segments with
    windowed db uploads) must produce a byte-identical ShimmerIndex."""
    import numpy as np

    from peregrine_tpu.config import AsmConfig
    from peregrine_tpu.io.seqdb import SeqDB
    from peregrine_tpu.ops.index import build_index, build_index_segmented
    from tests.simdata import random_genome, simulate_reads

    cfg = AsmConfig(k=12, w=24, r=4, levels=2, sketch_pad_len=8192,
                    sketch_batch=16)
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=2500, coverage=10.0)
    db = SeqDB.from_reads(reads)
    full = build_index(db, cfg)
    seg = build_index_segmented(db, cfg, budget_bytes=50000)  # many segments
    assert (seg.x == full.x).all() and (seg.y == full.y).all()
    assert (seg.mc_hash == full.mc_hash).all()
    assert (seg.mc_count == full.mc_count).all()


def test_amb_plane_elision_identical(rng):
    """upload_seqdb's ambiguity-plane elision (all-zero amb bytes become
    device zeros, saving a third of the upload) must yield
    planes numerically identical to the uploaded path, and dbs WITH
    ambiguous bases must keep the real plane."""
    import numpy as np
    import jax.numpy as jnp

    from peregrine_tpu.io.seqdb import SeqDB
    from peregrine_tpu.ops.dbgather import (_amb_plane, _pad_rows,
                                            pack_db_np, upload_seqdb)

    b2a = np.frombuffer(b"ACGT", np.uint8)
    clean = [(f"r{i}", b2a[rng.integers(0, 4, 3000)].tobytes())
             for i in range(8)]
    db = SeqDB.from_reads(clean)
    fw, ambb = pack_db_np(np.asarray(db.data, np.uint8))
    assert not ambb.any()
    planes = upload_seqdb(np.asarray(db.data, np.uint8))
    np.testing.assert_array_equal(np.asarray(planes.amb),
                                  _pad_rows(ambb, 1 << 17))

    dirty = list(clean)
    dirty[3] = ("rN", dirty[3][1][:1000] + b"N" * 5 + dirty[3][1][1005:])
    db2 = SeqDB.from_reads(dirty)
    fw2, ambb2 = pack_db_np(np.asarray(db2.data, np.uint8))
    assert ambb2.any()
    planes2 = upload_seqdb(np.asarray(db2.data, np.uint8))
    np.testing.assert_array_equal(np.asarray(planes2.amb),
                                  _pad_rows(ambb2, 1 << 17))
