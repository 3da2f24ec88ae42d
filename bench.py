"""Benchmark: SHIMMER index throughput per chip + cost-center stage metrics.

Prints ONE JSON line; the headline metric is the fused device index step,
and the "extra" object carries the cost-center metrics so a regression in
overlap or consensus shows up beside it:

  {"metric": "index_throughput", "value": <Mbases/s>, "unit": "Mbases/s",
   "vs_baseline": <ratio>,
   "extra": {"overlap_alignments_per_s": ..., "overlap_workers": ...,
             "cns_window_100kb_s": ..., "cns_windows_per_s": ...}}

Baseline: the reference shmr_index (single core, C, L0 output off) measured
at 90.9 Mbases/s on this machine (3000 x 15 kb synthetic reads; see
scripts/build_reference.sh + BASELINE.md).  If the reference binary is
available the baseline is re-measured live; otherwise the recorded constant
is used.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REF_BASELINE_MBASES_S = 90.9  # measured 2026-08-17, .ref_build/shmr_index, 1 core


def measure_reference(tmpdir: str) -> float | None:
    ref_bin = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ".ref_build", "shmr_index")
    if not os.path.exists(ref_bin):
        return None
    from peregrine_tpu.io.seqdb import SeqDB
    rng = np.random.default_rng(0)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    reads = [(f"r{i}", b2a[rng.integers(0, 4, 15000)].tobytes())
             for i in range(2000)]
    db = SeqDB.from_reads(reads)
    prefix = os.path.join(tmpdir, "seq_dataset")
    db.save(prefix)
    t0 = time.time()
    subprocess.run([ref_bin, "-p", prefix, "-t", "1", "-c", "1",
                    "-o", os.path.join(tmpdir, "shmr"), "-m", "0"],
                   check=True, capture_output=True)
    return float(db.lengths.sum()) / (time.time() - t0) / 1e6


def measure_overlap_alignments() -> tuple[float, int]:
    """Host overlap-confirm throughput: the parallel speculative aligner
    (native align_spec over all cores) on synthetic 15 kb pairs with ~10 kb
    true overlap and 1% error — the shape of the stage-2 hot loop."""
    import concurrent.futures as cf

    from peregrine_tpu.io.seqdb import SeqDB
    from peregrine_tpu.native import SPEC_REQ_DTYPE, align_spec

    rng = np.random.default_rng(1)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    n_pairs = 1500
    rl, shift = 15000, 5000
    reads = []
    for i in range(n_pairs):
        g = rng.integers(0, 4, rl + shift).astype(np.uint8)
        for part in (g[:rl], g[shift:]):
            r = part.copy()
            err = rng.random(rl) < 0.01
            r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
            reads.append((f"r{len(reads)}", b2a[r].tobytes()))
    db = SeqDB.from_reads(reads)
    reqs = np.zeros(n_pairs, SPEC_REQ_DTYPE)
    reqs["rid0"] = np.arange(n_pairs) * 2
    reqs["rid1"] = np.arange(n_pairs) * 2 + 1
    reqs["pos0"] = shift + 1
    reqs["pos1"] = 1
    res = np.zeros((n_pairs, 8), np.int32)
    workers = os.cpu_count() or 1
    step = -(-n_pairs // workers)
    t0 = time.time()
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        futs = [ex.submit(align_spec, reqs, lo, min(lo + step, n_pairs),
                          db.data, db.offsets, db.lengths, 100, res)
                for lo in range(0, n_pairs, step)]
        for f in futs:
            f.result()
    dt = time.time() - t0
    assert (res[:, 5] > 9000).mean() > 0.9  # sanity: real ~10 kb alignments
    return n_pairs / dt, workers


def measure_pair_build() -> float:
    """Fused pair-map + bucket-stream build (native/build_pairs.cpp) on a
    synthetic SHIMMER index shaped like 30x reads (hash pool sized for
    ~30x multiplicity, ~350 bp anchor spacing); returns records/s."""
    from peregrine_tpu.native import build_pairs_fused, bucket_stream_fused

    rng = np.random.default_rng(3)
    n_reads, per_read = 12000, 400
    n = n_reads * per_read
    pool = rng.integers(1, 1 << 44, n // 30, dtype=np.uint64)
    hashes = pool[rng.integers(0, len(pool), n)]
    span = np.uint64(16)
    x = (hashes << np.uint64(8)) | span
    rid = np.repeat(np.arange(n_reads, dtype=np.uint64), per_read)
    pos = np.tile((np.arange(per_read, dtype=np.uint64) + 1) * 350, n_reads)
    strand = rng.integers(0, 2, n).astype(np.uint64)
    y = (rid << np.uint64(32)) | (pos << np.uint64(1)) | strand
    rl = np.full(n_reads, (per_read + 2) * 350, np.int64)
    mh, counts = np.unique(hashes, return_counts=True)
    t0 = time.time()
    p = build_pairs_fused(x, y, mh, counts.astype(np.uint32), rl,
                          2, 240, 100)
    bucket_stream_fused(p[0], p[1], p[2], p[4], 120)
    dt = time.time() - t0
    assert len(p[0]) > n // 2
    return len(p[0]) / dt


def measure_cns_window() -> float:
    """Native consensus window core: one 100 kb template at 30x, 1% error
    (the stage-4 unit of work); returns seconds per window."""
    from peregrine_tpu.native import window_cns

    rng = np.random.default_rng(2)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    tpl = rng.integers(0, 4, 100000).astype(np.uint8)
    rl = 15000
    reads, shifts = [], []
    for s in range(0, len(tpl) - rl + 1, 500):
        r = tpl[s:s + rl].copy()
        err = rng.random(rl) < 0.01
        r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
        reads.append(b2a[r].tobytes())
        shifts.append(s)
    ref = b2a[tpl].tobytes()
    window_cns(ref, reads, shifts, 150, 1)  # warm
    n = 3
    t0 = time.time()
    for _ in range(n):
        out = window_cns(ref, reads, shifts, 150, 1)
    dt = (time.time() - t0) / n
    assert len(out) > 90000
    return dt


def measure_index_stage() -> float:
    """DELIVERED index-stage throughput: the whole stage as the pipeline
    runs it — host pack, upload (amb plane elided), device dispatch,
    compacted drain — on a 200 Mbase on-disk
    db.  This is the number to compare against the stage walls of the
    scale rungs; the headline kernel metric above deliberately excludes
    the transfer costs this one pays."""
    import tempfile

    from peregrine_tpu.config import AsmConfig
    from peregrine_tpu.io.seqdb import SeqDB
    from peregrine_tpu.ops.index import build_index

    rng = np.random.default_rng(4)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    n_reads, rl = 13_400, 15_000

    def gen():
        for i in range(n_reads):
            yield f"r{i:06d}", b2a[rng.integers(0, 4, rl)].tobytes()

    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "seq_dataset")
        SeqDB.build_to_disk_from_iter(gen(), prefix)
        db = SeqDB.open(prefix)
        cfg = AsmConfig(sketch_pad_len=32768, sketch_batch=256)
        t0 = time.time()
        idx = build_index(db, cfg)
        dt = time.time() - t0
        assert len(idx.x) > n_reads * 10
        return float(db.lengths.sum()) / dt / 1e6


def main() -> None:
    import peregrine_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp
    from peregrine_tpu.ops.index import index_step

    B, L = 8192, 32768
    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 4, size=(B, L), dtype=np.uint8))
    lengths = jnp.asarray(np.full(B, L, np.int32))
    rids = jnp.asarray(np.arange(B, dtype=np.uint32))

    def step():
        return index_step(codes, lengths, rids, w=80, k=16, r=6, levels=2,
                          cap=L // 8)

    jax.block_until_ready(step())  # compile + warm
    n = 6
    t0 = time.time()
    for _ in range(n):
        out = step()
    jax.block_until_ready(out)
    dt = (time.time() - t0) / n
    mbases = B * L / dt / 1e6

    baseline = REF_BASELINE_MBASES_S
    try:
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            live = measure_reference(td)
        if live:
            baseline = live
    except Exception:
        pass

    extra = {}
    try:
        aln_s, workers = measure_overlap_alignments()
        extra["overlap_alignments_per_s"] = round(aln_s, 1)
        extra["overlap_workers"] = workers
    except Exception:
        pass
    try:
        w_s = measure_cns_window()
        extra["cns_window_100kb_s"] = round(w_s, 4)
        extra["cns_windows_per_s"] = round(1.0 / w_s, 2)
    except Exception:
        pass
    try:
        extra["pair_build_records_per_s"] = round(measure_pair_build())
    except Exception:
        pass
    try:
        extra["index_stage_mbases_s"] = round(measure_index_stage(), 1)
    except Exception:
        pass

    print(json.dumps({"metric": "index_throughput",
                      "value": round(mbases, 1),
                      "unit": "Mbases/s",
                      "vs_baseline": round(mbases / baseline, 2),
                      "extra": extra}))


if __name__ == "__main__":
    sys.exit(main())
