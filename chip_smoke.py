#!/usr/bin/env python3
"""Smoke test of the assembler on a GPU: every device kernel of the main
path, compiled for the card, and one assembly through the normal entry
point.

    python chip_smoke.py [--seed 42]     # one card: phases A and B
    python chip_smoke.py --four-cards    # mesh paths on 4 cards vs one card

Phase B simulates an E. coli K12-shaped read set from the seed (4.6 Mb
circular genome, 30x of 15 kb +- 1.5 kb reads, 1% error, 40 kb wrap —
the reference's own CI shape), writes it as FASTA, runs
`pg-tpu asm reads.lst --with-consensus` in this process, and verifies the
polished contig base by base against the genome.  Phase A then compares
each device kernel of that path at the pipeline's widths with the same
program on the CPU backend, or with the host reference, bit for bit: no
device path does floating-point arithmetic.

With --four-cards only the multi-device paths run: the mesh index and
pair build (`--mesh`) and the sharded-seqdb aligner (`--shard-overlap`),
each compared byte for byte with the same work on device 0 alone.

The script exits non-zero without a result when JAX finds no GPU or the
repository is not beside it.  Its last line on stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the read set (reference test/ecoli_K12 simulator settings)
GENOME_BP = 4_600_000
COVERAGE = 30.0
READ_LEN = 15_000
READ_SD = 1_500
ERROR = 0.01
WRAP = 40_000
SKETCH_BATCH = 256          # scripts/ecoli_scale_run.py's batch
SLICE_READS = 2_000         # phase A's read slice
ALN_PAIRS = 1_024           # one aln_batch of 15 kb pairs
ALN_L = 16_384              # the aligner pad class of a 15 kb pair
MIN_CONTIG = 4_500_000
MIN_IDENTITY = 0.9999


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


# --- comparison helpers (device-agnostic; tests call them on the CPU) ----

def require(cond, msg: str) -> None:
    """An assertion that `python -O` does not strip."""
    if not cond:
        raise AssertionError(msg)


def assert_on(tree, dev) -> None:
    """Every array leaf of `tree` must live on device `dev`."""
    import jax
    for a in jax.tree.leaves(tree):
        if a.devices() != {dev}:
            raise AssertionError(f"result on {a.devices()}, expected {dev}")


def assert_same(got, want, what: str) -> None:
    """Bit-exact equality of two (nested) array collections."""
    import jax
    g = [np.asarray(a) for a in jax.tree.leaves(got)]
    w = [np.asarray(a) for a in jax.tree.leaves(want)]
    if len(g) != len(w) or not g:
        raise AssertionError(f"{what}: {len(g)} vs {len(w)} arrays")
    for i, (a, b) in enumerate(zip(g, w)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}[{i}]: {a.dtype}{a.shape} vs "
                                 f"{b.dtype}{b.shape}")
        if not np.array_equal(a, b):
            n = int((a != b).sum())
            raise AssertionError(f"{what}[{i}]: {n} of {a.size} differ")


def timed(fn, reps: int):
    """(result, first-call seconds incl. compile, seconds per warm call)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return out, first, (time.perf_counter() - t0) / reps


def check_index_step(db, L: int, B: int, dev, ref, reps: int = 5) -> dict:
    """index_step (sketch -> L1 -> L2, cap = L/8 as the pipeline runs it)
    on the first B reads that fit pad class L."""
    import jax
    from peregrine_tpu.ops.index import index_step

    rids = np.flatnonzero(db.lengths <= L)[:B]
    require(len(rids) == B,
            f"only {len(rids)} reads fit L={L}")
    codes, lens = db.padded_code_batch(rids, L)
    args = (codes, lens, rids.astype(np.uint32))
    kw = dict(w=80, k=16, r=6, levels=2, cap=L // 8)

    def run(d):
        a = [jax.device_put(x, d) for x in args]
        return lambda: index_step(*a, **kw)

    got, first, per = timed(run(dev), reps)
    assert_on(got, dev)
    want = jax.block_until_ready(run(ref)())
    assert_same(got, want, f"index_step[{B},{L}]")
    return {"first_s": first, "step_s": per,
            "padded_mbases_s": B * L / per / 1e6,
            "read_mbases_s": float(lens.sum()) / per / 1e6,
            "records": int(np.asarray(got[2]).sum())}


def check_index_scan(db, cfg, dev, ref):
    """The stage-1 device path on a read slice: the device-resident
    seqdb, one index_step_db_scan group and its _compact_drain, and
    build_index as the pipeline calls it — each against build_index on
    the reference device (ShimmerIndex x, y and counts).  Returns
    (stats, reference index)."""
    import jax
    import jax.numpy as jnp
    from peregrine_tpu.ops.dbgather import upload_seqdb
    from peregrine_tpu.ops.index import (INDEX_SCAN_GROUP, _compact_drain,
                                         _merge_counts, build_index,
                                         index_step_db_scan)

    with jax.default_device(ref):
        want = build_index(db, cfg)
    t0 = time.perf_counter()
    with jax.default_device(dev):
        got = build_index(db, cfg)
    t_build = time.perf_counter() - t0
    for f in ("x", "y", "mc_hash", "mc_count"):
        assert_same(getattr(got, f), getattr(want, f), f"build_index.{f}")

    # one scan group covering the whole slice, rid-ordered
    n = len(db)
    G = INDEX_SCAN_GROUP
    B = -(-n // G)
    L = int(-(-int(db.lengths.max()) // 8192) * 8192)
    metas = np.zeros((G * B, 3), np.int64)
    metas[:n, 0] = db.offsets
    metas[:n, 1] = db.lengths
    metas[:n, 2] = np.arange(n)
    cap = max(256, L // 8)
    with jax.default_device(dev):
        rows = upload_seqdb(db.data)
        xl, yl, cl, c0 = index_step_db_scan(
            rows, jnp.asarray(metas.reshape(G, B, 3)), L=L, w=cfg.w,
            k=cfg.k, r=cfg.r, levels=cfg.levels, cap=cap)
        xf, yf, tot = _compact_drain(xl, yl, cl)
    assert_on((rows, xl, yl, cl, c0, xf, yf, tot), dev)
    tot, cl, c0 = (int(tot), np.asarray(cl), np.asarray(c0))
    require((c0 <= cap).all() and (cl <= xl.shape[-1]).all(),
            "cap overflow")
    x = np.asarray(xf[:tot])
    y = np.asarray(yf[:tot])
    mh, mc = _merge_counts(x >> np.uint64(8), np.ones(len(x), np.uint32))
    assert_same((x, y, mh, mc), (want.x, want.y, want.mc_hash,
                                 want.mc_count), "index_step_db_scan")
    return {"build_index_s": t_build, "records": len(want.x), "L": L}, want


def aln_pairs(db, truth, n: int, L: int, seed: int) -> np.ndarray:
    """[n, 7] aligner request columns (q_off, q_rstart, q_len, q_strand,
    t_off, t_len, t_strand): forward-strand read pairs that overlap on
    the genome, query window clipped to start at the target's locus; a
    quarter get random strands to exercise the mirrored gather."""
    rng = np.random.default_rng(seed)
    start = np.asarray([t[0] for t in truth], np.int64)
    fwd = np.flatnonzero((np.asarray([t[2] for t in truth]) == 0)
                         & (db.lengths <= L))
    fwd = fwd[np.argsort(start[fwd], kind="stable")]
    cols = []
    for step in (1, 2, 3):   # each read against its next loci on the genome
        for a, b in zip(fwd[:-step], fwd[step:]):
            shift = int(start[b] - start[a])
            if len(cols) < n and 0 <= shift < int(db.lengths[a]) - 1000:
                cols.append((db.offsets[a] + shift, db.offsets[a],
                             db.lengths[a] - shift, 0, db.offsets[b],
                             db.lengths[b], 0))
    require(len(cols) == n,
            f"only {len(cols)} overlapping pairs")
    cols = np.asarray(cols, np.int64)
    flip = rng.random(n) < 0.25
    cols[flip, 3] = rng.integers(0, 2, int(flip.sum()))
    cols[flip, 6] = rng.integers(0, 2, int(flip.sum()))
    return cols


def check_myers(db, cols: np.ndarray, L: int, dev, ref, unroll: int,
                reps: int = 3) -> dict:
    """myers_batch_db (through the packed-column form the overlap stage
    dispatches) against the same program on the reference device."""
    import jax
    from peregrine_tpu.ops.dbgather import upload_seqdb
    from peregrine_tpu.ops.device_align import myers_batch_db_packed

    def run(d, u):
        with jax.default_device(d):
            rows = upload_seqdb(db.data)
        c = jax.device_put(cols, d)
        return lambda: myers_batch_db_packed(rows, c, L=L, nb=8, unroll=u)

    got, first, per = timed(run(dev, unroll), reps)
    assert_on(got, dev)
    want = jax.block_until_ready(run(ref, 1)())
    assert_same(got, want, f"myers_batch_db[{len(cols)},{L}]")
    d = np.asarray(got[0])
    return {"first_s": first, "batch_s": per,
            "alignments_s": len(cols) / per,
            "median_dist": float(np.median(d))}


def check_pairs(idx, lengths, cfg, dev) -> dict:
    """build_pairs_device on `dev` against the threaded host build."""
    import jax
    from peregrine_tpu.ops.device_pairs import build_pairs_device
    from peregrine_tpu.ops.overlap import bucket_stream, build_pairs

    host = build_pairs(idx, lengths, mc_lower=cfg.mc_lower,
                       mc_upper=cfg.mc_upper, min_dist=cfg.min_anchor_dist)
    host_stream = bucket_stream(host[0], host[1], host[2], host[4],
                                cfg.ovlp_upper)
    t0 = time.perf_counter()
    with jax.default_device(dev):
        pairs, stream = build_pairs_device(
            idx, lengths, cfg.mc_lower, cfg.mc_upper, cfg.min_anchor_dist,
            cfg.ovlp_upper)
    dt = time.perf_counter() - t0
    require(len(host[0]) > 0,
            "no pairs")
    assert_same(pairs, host, "build_pairs_device.pairs")
    assert_same(stream, host_stream, "build_pairs_device.stream")
    return {"seconds": dt, "records": len(host[0])}


def check_gather(db, L: int, n: int, dev, seed: int) -> dict:
    """upload_seqdb + gather_codes on `dev` against the host decode of
    the 4-bit codec, both strands, windows ending at their read's end."""
    import jax
    import jax.numpy as jnp
    from peregrine_tpu.io.seqdb import packed_to_codes
    from peregrine_tpu.ops.dbgather import (gather_codes, gather_offsets,
                                            upload_seqdb)

    rng = np.random.default_rng(seed)
    rid = rng.choice(np.flatnonzero(db.lengths <= L), n)
    shift = np.minimum(rng.integers(0, 4000, n), db.lengths[rid] - 1)
    off = db.offsets[rid] + shift
    ln = (db.lengths[rid] - shift).astype(np.int32)
    strand = rng.integers(0, 2, n).astype(np.int32)
    goff = gather_offsets(off, ln, strand, db.offsets[rid], L)
    gather = jax.jit(gather_codes, static_argnames=("L", "fill"))
    with jax.default_device(dev):
        rows = upload_seqdb(db.data)
        got = gather(rows, jnp.asarray(goff), jnp.asarray(ln),
                     jnp.asarray(strand), L=L, fill=4)
    assert_on((rows, got), dev)
    want = np.full((n, L), 4, np.uint8)
    for b in range(n):
        want[b, :ln[b]] = packed_to_codes(
            db.data[off[b]:off[b] + ln[b]], int(strand[b]))
    assert_same(got, want, f"gather_codes[{n},{L}]")
    return {"windows": n}


# --- phases ---------------------------------------------------------------

def simulate(seed: int, genome_bp: int = GENOME_BP):
    # by path: an installed package named `tests` may shadow the repo's
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from simdata import random_genome, simulate_reads
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_bp)
    reads, truth = simulate_reads(rng, genome, read_len=READ_LEN,
                                  coverage=COVERAGE, len_sd=READ_SD,
                                  error=ERROR, circular_wrap=WRAP)
    return genome, reads, truth


def write_reads(reads, workdir: str) -> str:
    fa = os.path.join(workdir, "reads.fa")
    with open(fa, "wb") as f:
        for name, seq in reads:
            f.write(b">" + name.encode() + b"\n" + seq + b"\n")
    lst = os.path.join(workdir, "reads.lst")
    with open(lst, "w") as f:
        f.write(fa + "\n")
    return lst


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_b(genome: bytes, reads, workdir: str, sketch_batch: int,
            min_contig: int = MIN_CONTIG) -> dict:
    """`pg-tpu asm reads.lst --with-consensus` in this process (a second
    process could not open the card this one holds), then exact
    full-coverage verification of the polished contig."""
    from peregrine_tpu import cli
    from peregrine_tpu.io.seqdb import read_fastx
    from peregrine_tpu.verify import verify_fasta

    lst = write_reads(reads, workdir)
    out = os.path.join(workdir, "wd")
    log = logging.getLogger("peregrine_tpu")
    cap = _Lines()
    log.addHandler(cap)
    t0 = time.perf_counter()
    try:
        rc = cli.main(["asm", lst, "--output", out, "--with-consensus",
                       "--sketch-batch", str(sketch_batch)])
    finally:
        log.removeHandler(cap)
    wall = time.perf_counter() - t0
    require(rc == 0,
            f"pg-tpu asm exited {rc}")
    fa = os.path.join(out, "4-cns", "p_ctg_cns.fa")
    n_ctg = sum(1 for _ in read_fastx(fa))
    res = verify_fasta(fa, genome, circular=True)
    require(len(res) == 1,
            f"{len(res)} contigs >= 50 kb (want 1)")
    r = res[0]
    require(r.get("anchored"),
            "contig does not anchor on the genome")
    require(r["length"] >= min_contig,
            f"contig {r['length']} bp")
    require(r["identity"] >= MIN_IDENTITY,
            f"identity {r['identity']}")
    return {"wall_s": wall, "contigs": n_ctg, "length": r["length"],
            "distance": r["distance"], "identity": r["identity"],
            "stage_lines": [m for m in cap.lines if m.startswith("stage")]}


def phase_a(reads, truth, dev, ref, unroll: int, seed: int) -> None:
    from peregrine_tpu.config import AsmConfig
    from peregrine_tpu.io.seqdb import SeqDB

    db = SeqDB.from_reads(reads[:SLICE_READS])
    for B, L in ((256, 16384), (64, 32768)):
        t0 = time.perf_counter()
        r = check_index_step(db, L, B, dev, ref)
        print(f"index_step [{B}, {L}] bit-exact vs cpu: first call "
              f"{r['first_s']:.2f} s, step {r['step_s'] * 1e3:.3f} ms = "
              f"{r['padded_mbases_s']:.1f} padded Mbases/s "
              f"({r['read_mbases_s']:.1f} read Mbases/s), check "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = AsmConfig(sketch_batch=SKETCH_BATCH)
    t0 = time.perf_counter()
    r, idx = check_index_scan(db, cfg, dev, ref)
    print(f"build_index + index_step_db_scan/_compact_drain "
          f"[{len(db)} reads, L={r['L']}] bit-exact vs cpu build_index: "
          f"{r['records']} records, device build_index "
          f"{r['build_index_s']:.2f} s, check "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cols = aln_pairs(db, truth[:SLICE_READS], ALN_PAIRS, ALN_L, seed)
    r = check_myers(db, cols, ALN_L, dev, ref, unroll)
    print(f"myers_batch_db [{ALN_PAIRS}, {ALN_L}] unroll={unroll} "
          f"bit-exact vs cpu: first call {r['first_s']:.2f} s, batch "
          f"{r['batch_s'] * 1e3:.1f} ms = {r['alignments_s']:.0f} "
          f"alignments/s, median distance {r['median_dist']:.0f}, "
          f"check {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    r = check_pairs(idx, db.lengths, cfg, dev)
    print(f"build_pairs_device bit-exact vs host build_pairs: "
          f"{r['records']} records, {r['seconds']:.2f} s, check "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    r = check_gather(db, ALN_L, 512, dev, seed)
    print(f"upload_seqdb/gather_codes [{r['windows']}, {ALN_L}] bit-exact "
          f"vs host decode: check {time.perf_counter() - t0:.1f} s",
          flush=True)


def device_peaks(devs) -> list[int]:
    return [d.memory_stats()["peak_bytes_in_use"] for d in devs]


def four_cards(reads, truth, devs, workdir: str, unroll: int, seed: int,
               min_contig: int = MIN_CONTIG) -> None:
    """--mesh and --shard-overlap on all `devs` against device 0 alone."""
    import jax
    from peregrine_tpu.config import AsmConfig
    from peregrine_tpu.io.seqdb import SeqDB
    from peregrine_tpu.ops.dbgather import upload_seqdb
    from peregrine_tpu.ops.device_align import myers_batch_db_packed
    from peregrine_tpu.ops.device_pairs import build_pairs_device
    from peregrine_tpu.parallel.sharded_index import make_mesh
    from peregrine_tpu.parallel.sharded_overlap import (shard_seqdb,
                                                        sharded_align)
    from peregrine_tpu.pipeline.run import Assembly

    n = len(devs)
    cfg = AsmConfig(sketch_batch=SKETCH_BATCH)
    t0 = time.perf_counter()
    mesh_asm = Assembly(os.path.join(workdir, "mesh"), cfg.replace(mesh=True))
    fa_mesh = mesh_asm.run_draft(reads=reads)
    t_mesh = time.perf_counter() - t0
    peaks = device_peaks(devs)
    require(all(p > 0 for p in peaks),
            f"idle devices: peaks {peaks}")
    t0 = time.perf_counter()
    with jax.default_device(devs[0]):
        one = Assembly(os.path.join(workdir, "one"), cfg)
        fa_one = one.run_draft(reads=reads)
        dev_pairs, _ = build_pairs_device(
            one.idx, one.db.lengths, cfg.mc_lower, cfg.mc_upper,
            cfg.min_anchor_dist, cfg.ovlp_upper)
    t_one = time.perf_counter() - t0
    for f in ("x", "y", "mc_hash", "mc_count"):
        assert_same(getattr(mesh_asm.idx, f), getattr(one.idx, f),
                    f"mesh index.{f}")
    # the shared pair map (built in stage 2 when overlap runs threaded)
    mesh_pairs = mesh_asm._pair_map()
    with jax.default_device(devs[0]):
        host_pairs = one._pair_map()
    assert_same(mesh_pairs, host_pairs, "build_pairs_mesh vs host")
    assert_same(mesh_pairs, dev_pairs, "build_pairs_mesh vs device 0")
    with open(fa_mesh, "rb") as f:
        c_mesh = f.read()
    with open(fa_one, "rb") as f:
        c_one = f.read()
    require(c_mesh == c_one and len(c_one) > min_contig,
            f"draft contigs differ ({len(c_mesh)} vs {len(c_one)} bytes)")
    print(f"--mesh draft on {n} devices: index, pair map and p_ctg.fa "
          f"byte-identical to device 0 ({len(c_one)} bytes); draft wall "
          f"{t_mesh:.1f} s on {n} vs {t_one:.1f} s on 1; per-device peak "
          f"{[round(p / 2**30, 2) for p in peaks]} GiB", flush=True)

    db = SeqDB.from_reads(reads[:SLICE_READS])
    cols = aln_pairs(db, truth[:SLICE_READS], ALN_PAIRS, ALN_L, seed)
    sdb = shard_seqdb(db.data, db.offsets, db.lengths, make_mesh(n))
    spread = {s.device for s in sdb.fw.addressable_shards}
    require(len(spread) == n,
            f"seqdb shards on {len(spread)} devices")
    q_rid = np.searchsorted(db.offsets, cols[:, 1])
    t_rid = np.searchsorted(db.offsets, cols[:, 4])
    t0 = time.perf_counter()
    got = sharded_align(sdb, q_rid, cols[:, 0], cols[:, 2].astype(np.int32),
                        cols[:, 3].astype(np.int32), t_rid, cols[:, 4],
                        cols[:, 5].astype(np.int32),
                        cols[:, 6].astype(np.int32), L=ALN_L, nb=8,
                        unroll=unroll)
    t_sh = time.perf_counter() - t0
    with jax.default_device(devs[0]):
        rows = upload_seqdb(db.data)
        want = myers_batch_db_packed(rows, jax.device_put(cols, devs[0]),
                                     L=ALN_L, nb=8, unroll=unroll)
    assert_on(want, devs[0])
    assert_same(got, want, "sharded_align vs device 0")
    print(f"--shard-overlap: sharded_align over a {n}-way seqdb "
          f"[{ALN_PAIRS}, {ALN_L}] bit-exact vs myers_batch_db on device 0 "
          f"({t_sh:.1f} s incl. compile)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--four-cards", action="store_true",
                    help="run the mesh and sharded-overlap paths on 4 "
                         "cards against device 0, and nothing else")
    args = ap.parse_args(argv)

    if not (os.path.isdir(os.path.join(REPO, "peregrine_tpu"))
            and os.path.isfile(os.path.join(REPO, "tests", "simdata.py"))):
        fail(f"the repository is not beside this script ({REPO})")
    sys.path.insert(0, REPO)
    import jax
    if jax.default_backend() != "gpu":
        fail(f"no GPU: JAX backend is {jax.default_backend()!r}")
    import peregrine_tpu  # noqa: F401  (x64, compile cache)
    from peregrine_tpu.ops.device_align import default_unroll

    devs = jax.devices()
    n = 4 if args.four_cards else 1
    if len(devs) < n:
        fail(f"{n} cards needed, JAX sees {len(devs)}")
    devs = devs[:n]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    for line in smi[:n]:   # the card's name and power limit, verbatim
        print(line, flush=True)
    print(f"device_kind: {devs[0].device_kind}; devices used: {n}; "
          f"host cores: {os.cpu_count()}", flush=True)
    print(f"jax {jax.__version__}; compile cache: "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)
    unroll = default_unroll()
    t0 = time.perf_counter()
    import peregrine_tpu.native  # noqa: F401  (g++ build on a fresh checkout)
    print(f"native host library ready ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    genome, reads, truth = simulate(args.seed)
    print(f"simulated {len(reads)} reads, "
          f"{sum(len(s) for _, s in reads) / 1e6:.1f} Mbases "
          f"(seed {args.seed}, {time.perf_counter() - t0:.1f} s)", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        if args.four_cards:
            four_cards(reads, truth, devs, workdir, unroll, args.seed)
        else:
            r = phase_b(genome, reads, workdir, SKETCH_BATCH)
            for ln in r["stage_lines"]:
                print(f"  {ln}", flush=True)
            peak = devs[0].memory_stats()["peak_bytes_in_use"]
            print(f"phase B: pg-tpu asm --with-consensus {r['wall_s']:.1f} s;"
                  f" {r['contigs']} contig(s), verified {r['length']} bp at "
                  f"distance {r['distance']}, identity {r['identity']:.7f};"
                  f" peak device memory {peak / 2**30:.2f} GiB", flush=True)
            ref = jax.devices("cpu")[0]
            phase_a(reads, truth, devs[0], ref, unroll, args.seed)

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
