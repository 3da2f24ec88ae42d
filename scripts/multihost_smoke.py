"""Multi-host (multi-process) smoke test of the sharded device programs.

Launches N_PROC controller processes (jax.distributed over localhost, CPU
backend, 4 virtual devices each) and runs the hash-shard index exchange
and the sharded-seqdb overlap alignment over the GLOBAL mesh — the same
code path a multi-host device mesh runs, minus the interconnect.  Validates that
parallel/distributed.py + shard_map programs work multi-controller, not
just on a single-process virtual mesh.

    python scripts/multihost_smoke.py            # orchestrates both ranks
    (exit 0 + "MULTIHOST OK" from every rank = pass)
"""

import os
import subprocess
import sys

N_PROC = 2
DEV_PER_PROC = 4
PORT = 12437


def worker(rank: int) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEV_PER_PROC}")
    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    import numpy as np

    from peregrine_tpu.parallel.distributed import init_distributed
    pid = init_distributed(coordinator_address=f"localhost:{PORT}",
                           num_processes=N_PROC, process_id=rank)
    assert jax.process_count() == N_PROC, jax.process_count()
    n_global = len(jax.devices())
    assert n_global == N_PROC * DEV_PER_PROC, n_global

    from peregrine_tpu.io.seqdb import SeqDB
    from peregrine_tpu.parallel.sharded_index import make_mesh, sharded_index
    from simdata import random_genome, simulate_reads

    rng = np.random.default_rng(0)  # identical data on every rank
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=2000, coverage=8.0)
    db = SeqDB.from_reads(reads)
    L = 4096
    codes, lens = db.padded_code_batch(range(len(db)), L)
    pad = (-len(db)) % n_global
    if pad:
        codes = np.concatenate([codes, np.full((pad, L), 4, np.uint8)])
        lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
    rids = np.arange(len(lens), dtype=np.uint32)

    mesh = make_mesh(n_global)
    import jax.numpy as jnp
    rx, ry, nv, sent, overflow = sharded_index(
        mesh, jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(rids),
        w=24, k=12, r=4, levels=2, cap_per_pair=512)
    # each process addresses only its local shards of the global output
    local_nv = [int(s.data.sum()) for s in nv.addressable_shards]
    total = jax.device_get(nv.sum())
    assert total > 0, "no index records produced"

    from peregrine_tpu.parallel.sharded_overlap import shard_seqdb, sharded_align
    sdb = shard_seqdb(db.data, db.offsets, db.lengths, mesh)
    nreq = 2 * n_global
    q_rid = rng.integers(0, len(db), nreq)
    t_rid = rng.integers(0, len(db), nreq)
    d, qe, te = sharded_align(
        sdb, q_rid, db.offsets[q_rid], db.lengths[q_rid].astype(np.int32),
        np.zeros(nreq, np.int32), t_rid, db.offsets[t_rid],
        db.lengths[t_rid].astype(np.int32), np.ones(nreq, np.int32),
        L=2048, nb=8, unroll=1)
    assert d.shape == (nreq,)
    print(f"MULTIHOST OK rank={pid} devices={n_global} "
          f"index_records={int(total)} local_nv={local_nv} "
          f"aln_mean_dist={float(np.mean(d)):.1f}", flush=True)


def main() -> int:
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(N_PROC)]
    rc = 0
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        ok = p.returncode == 0 and "MULTIHOST OK" in out
        print(f"--- rank {r} (rc={p.returncode}) ---")
        print(out[-2000:])
        rc |= 0 if ok else 1
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]))
    else:
        sys.exit(main())
