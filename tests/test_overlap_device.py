import numpy as np

from peregrine_tpu.config import AsmConfig
from peregrine_tpu.io.seqdb import SeqDB
from peregrine_tpu.native import spec_enum
from peregrine_tpu.ops.index import build_index
from peregrine_tpu.ops.overlap import (_bucket_stream, _spec_enum_np,
                                       build_pairs, overlap_chunk,
                                       overlap_chunk_device)
from tests.simdata import random_genome, simulate_reads


def test_spec_enum_native_matches_numpy(rng):
    cfg = AsmConfig(k=12, w=24, r=4, levels=2, min_ovlp_aln=300,
                    sketch_pad_len=8192, sketch_batch=16)
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=12.0)
    db = SeqDB.from_reads(reads)
    idx = build_index(db, cfg)
    key0, key1, y0a, y1a, dira = build_pairs(
        idx, db.lengths, 1, 1, cfg.mc_lower, cfg.mc_upper,
        cfg.min_anchor_dist)
    sys_, sdirs, spos, sbs, sbe, sbid = _bucket_stream(
        key0, key1, y0a, dira, cfg.ovlp_upper)
    assert len(sys_) > 0

    for window, per_pair in ((12, 1), (5, 2)):
        r0, r1, p0, p1, s0, s1, ka, kb = _spec_enum_np(
            sys_, sdirs, spos, sbid, window, per_pair)
        reqs = spec_enum(sys_, sdirs, spos, sbs, sbe, window, per_pair)
        assert len(reqs) == len(r0)
        np.testing.assert_array_equal(reqs["rid0"], r0.astype(np.uint32))
        np.testing.assert_array_equal(reqs["rid1"], r1.astype(np.uint32))
        np.testing.assert_array_equal(reqs["pos0"], p0.astype(np.int32))
        np.testing.assert_array_equal(reqs["pos1"], p1.astype(np.int32))
        np.testing.assert_array_equal(reqs["strand0"], s0.astype(np.uint8))
        np.testing.assert_array_equal(reqs["strand1"], s1.astype(np.uint8))


def test_device_overlap_matches_host(rng):
    cfg = AsmConfig(k=12, w=24, r=4, levels=2, min_ovlp_aln=300,
                    sketch_pad_len=8192, sketch_batch=16)
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=12.0)
    db = SeqDB.from_reads(reads)
    idx = build_index(db, cfg)

    host = overlap_chunk(db, idx, cfg)
    dev = overlap_chunk_device(db, idx, cfg)

    def pairs(recs):
        return {tuple(sorted((int(o["y0"] >> np.uint64(32)),
                              int(o["y1"] >> np.uint64(32))))) for o in recs}

    hp, dp = pairs(host), pairs(dev)
    jac = len(hp & dp) / max(len(hp | dp), 1)
    # aligner dist differences can flip borderline accepts; demand near-parity
    assert jac > 0.95, (len(hp), len(dp), jac)

    # classification agreement on shared pairs
    def types(recs):
        return {tuple(sorted((int(o["y0"] >> np.uint64(32)),
                              int(o["y1"] >> np.uint64(32))))): int(o["ovlp_type"])
                for o in recs}

    ht, dt = types(host), types(dev)
    shared = set(ht) & set(dt)
    agree = sum(1 for p in shared if ht[p] == dt[p])
    assert agree / max(len(shared), 1) > 0.95


def test_hybrid_overlap_matches_host(rng):
    """overlap_all_hybrid (device thread + host threads pulling chunks from
    one queue) reproduces the host chunked path at pair-set level."""
    from peregrine_tpu.ops.overlap import overlap_all, overlap_all_hybrid

    cfg = AsmConfig(k=12, w=24, r=4, levels=2, min_ovlp_aln=300,
                    sketch_pad_len=8192, sketch_batch=16, aln_batch=64)
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=12.0)
    db = SeqDB.from_reads(reads)
    idx = build_index(db, cfg)

    # dedup=False: compare the legacy hash-chunked path like-for-like
    # (hybrid pulls the same per-chunk work units)
    host = overlap_all(db, idx, cfg, n_chunks=4, n_workers=2, dedup=False)
    hyb = overlap_all_hybrid(db, idx, cfg, n_chunks=4, n_host_workers=2)

    def pairs(recs):
        return {tuple(sorted((int(o["y0"] >> np.uint64(32)),
                              int(o["y1"] >> np.uint64(32))))) for o in recs}

    hp, yp = pairs(host), pairs(hyb)
    jac = len(hp & yp) / max(len(hp | yp), 1)
    assert jac > 0.95, (len(hp), len(yp), jac)


def test_overlap_all_spec_device_backend(rng):
    """overlap_all_spec(backend='device'/'hybrid') agrees with the host
    backend at pair level (dist/endpoint semantics differ per
    ops/device_align.py docstring), and both are deterministic."""
    import numpy as np

    from peregrine_tpu.ops.index import build_index
    from peregrine_tpu.ops.overlap import overlap_all_spec

    cfg = AsmConfig(k=12, w=24, r=4, levels=2, min_ovlp_aln=300,
                    sketch_pad_len=8192, sketch_batch=16, aln_batch=64,
                    aln_max_len=8192)
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=12.0)
    db = SeqDB.from_reads(reads)
    idx = build_index(db, cfg)

    host = overlap_all_spec(db, idx, cfg, n_workers=2, backend="host")
    dev = overlap_all_spec(db, idx, cfg, n_workers=2, backend="device")
    dev2 = overlap_all_spec(db, idx, cfg, n_workers=2, backend="device")
    hyb = overlap_all_spec(db, idx, cfg, n_workers=2, backend="hybrid")

    def pairs(recs):
        return {tuple(sorted((int(o["y0"] >> np.uint64(32)),
                              int(o["y1"] >> np.uint64(32))))) for o in recs}

    hp, dp, yp = pairs(host), pairs(dev), pairs(hyb)
    assert len(hp) > 30
    assert len(hp & dp) / max(len(hp | dp), 1) > 0.9
    assert len(hp & yp) / max(len(hp | yp), 1) > 0.9
    # device backend is deterministic run to run
    np.testing.assert_array_equal(
        dev.view(np.uint8).reshape(len(dev), -1),
        dev2.view(np.uint8).reshape(len(dev2), -1))
