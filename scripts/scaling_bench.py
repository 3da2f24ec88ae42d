"""Multi-device weak-scaling benchmark: sharded index + sharded overlap.

Measures the BASELINE.json targets (per-chip overlap+index throughput and
multi-device scaling efficiency): each device receives the same per-device
workload, so perfect scaling keeps the wall constant as devices are added
(efficiency_n = T_1 / T_n).

    python scripts/scaling_bench.py             # the accelerator backend
    python scripts/scaling_bench.py --cpu       # 8 virtual CPU devices:
                                                # validates the mesh programs
                                                # and the harness, NOT perf
                                                # (all 8 share the host cores)

On a multi-GPU host this script runs unchanged over all local devices; add
`--multihost` after `jax.distributed.initialize` (parallel/distributed.py)
for N>=2 hosts.  Prints one JSON line per (stage, n_devices).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reads-per-dev", type=int, default=64)
    ap.add_argument("--read-len", type=int, default=16384)
    ap.add_argument("--aln-per-dev", type=int, default=256)
    args = ap.parse_args()

    if args.cpu:
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=8")
    import peregrine_tpu  # noqa: F401
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from peregrine_tpu.parallel.sharded_index import make_mesh, sharded_index
    from peregrine_tpu.parallel.sharded_overlap import (shard_seqdb,
                                                        sharded_align)
    from peregrine_tpu.io.seqdb import SeqDB

    n_all = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8) if n <= n_all]
    rng = np.random.default_rng(0)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    results = []

    def timeit(fn, reps=4):
        jax.block_until_ready(fn())
        t0 = time.time()
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        return (time.time() - t0) / reps

    L = args.read_len
    for n in sizes:
        B = n * args.reads_per_dev
        codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
        lengths = np.full(B, L, np.int32)
        rids = np.arange(B, dtype=np.uint32)
        mesh = make_mesh(n)
        import jax.numpy as jnp
        cj, lj, rj = jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(rids)
        # per-(src,dst) capacity: ~B*L/8 records spread over n^2 pairs
        cap = max(4096, (args.reads_per_dev * L // 6) // n)
        dt = timeit(lambda: sharded_index(mesh, cj, lj, rj, w=80, k=16, r=6,
                                          levels=2, cap_per_pair=cap))
        results.append({"stage": "sharded_index", "n_devices": n,
                        "wall_s": round(dt, 4),
                        "mbases_per_s": round(B * L / dt / 1e6, 1)})
        print(json.dumps(results[-1]), flush=True)

    # sharded overlap alignment: requests ride all_to_all to the target
    # owner; each device aligns aln_per_dev pairs of 8 kb windows
    n_reads = 512
    reads = [(f"r{i}", b2a[rng.integers(0, 4, 8192)].tobytes())
             for i in range(n_reads)]
    db = SeqDB.from_reads(reads)
    for n in sizes:
        mesh = make_mesh(n)
        sdb = shard_seqdb(db.data, db.offsets, db.lengths, mesh)
        nreq = n * args.aln_per_dev
        q_rid = rng.integers(0, n_reads, nreq)
        t_rid = rng.integers(0, n_reads, nreq)
        q_off = db.offsets[q_rid]
        q_len = db.lengths[q_rid].astype(np.int32)
        t_off = db.offsets[t_rid]
        t_len = db.lengths[t_rid].astype(np.int32)
        qs = rng.integers(0, 2, nreq).astype(np.int32)
        ts = rng.integers(0, 2, nreq).astype(np.int32)
        unroll = 1 if args.cpu else 32
        dt = timeit(lambda: sharded_align(
            sdb, q_rid, q_off, q_len, qs, t_rid, t_off, t_len, ts,
            L=8192, nb=8, unroll=unroll), reps=2)
        results.append({"stage": "sharded_overlap_align", "n_devices": n,
                        "wall_s": round(dt, 4),
                        "alignments_per_s": round(nreq / dt, 1)})
        print(json.dumps(results[-1]), flush=True)

    base_idx = {r["stage"]: r["wall_s"] for r in results if r["n_devices"] == 1}
    for r in results:
        if r["n_devices"] > 1:
            eff = base_idx[r["stage"]] / r["wall_s"]
            print(json.dumps({"stage": r["stage"],
                              "n_devices": r["n_devices"],
                              "weak_scaling_efficiency": round(eff, 3)}),
                  flush=True)


if __name__ == "__main__":
    main()
