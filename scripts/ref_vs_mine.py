"""Head-to-head: reference pipeline vs peregrine_tpu on identical reads."""
import os, subprocess, sys, time
import numpy as np
sys.path.insert(0, "/root/repo/tests")
from simdata import random_genome, simulate_reads
from peregrine_tpu.config import AsmConfig
from peregrine_tpu.pipeline.run import Assembly
from peregrine_tpu.io.seqdb import read_fastx, revcomp
from peregrine_tpu.native import dw_align

REF = "/root/repo/.ref_build"
RSCRIPTS = "/root/reference/py/scripts"

def run(cmd, cwd, **kw):
    r = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                       shell=isinstance(cmd, str), **kw)
    if r.returncode != 0:
        print("FAILED:", cmd, "\n", r.stderr[-1500:], flush=True)
        raise SystemExit(1)
    return r

if __name__ == "__main__":
    base = "/tmp/h2h"
    os.makedirs(base + "/ref", exist_ok=True)
    rng = np.random.default_rng(4242)
    genome = random_genome(rng, 2_000_000)
    reads, _ = simulate_reads(rng, genome, read_len=15000, coverage=30.0,
                              len_sd=1500, error=0.01, circular_wrap=40000)
    fa = base + "/reads.fa"
    with open(fa, "w") as f:
        for n, s in reads:
            f.write(f">{n}\n{s.decode()}\n")
    with open(base + "/reads.lst", "w") as f:
        f.write(fa + "\n")
    print(f"{len(reads)} reads", flush=True)

    # --- mine ---------------------------------------------------------
    t0 = time.time()
    asm = Assembly(base + "/mine", AsmConfig(sketch_pad_len=32768, sketch_batch=256))
    asm.run_draft(reads_list=base + "/reads.lst")
    print(f"mine draft: {time.time()-t0:.0f}s", flush=True)

    # --- reference ----------------------------------------------------
    t0 = time.time()
    ref = base + "/ref"
    run([REF + "/shmr_mkseqdb", "-p", "seq_dataset", "-d", base + "/reads.lst"], ref)
    run([REF + "/shmr_index", "-p", "seq_dataset", "-t", "1", "-c", "1",
         "-o", "shmr", "-m", "0"], ref)
    run([REF + "/shmr_overlap", "-p", "seq_dataset", "-l", "shmr-L2",
         "-t", "1", "-c", "1", "-o", "ovlp.01"], ref)
    run(f"{REF}/shmr_dedup < ovlp.01 > preads.ovl && echo - >> preads.ovl", ref)
    env = dict(os.environ, PYTHONPATH="/tmp/refstack", PYTHONHASHSEED="0")
    run([sys.executable, RSCRIPTS + "/ovlp_to_graph.py"], ref, env=env)
    run([sys.executable, RSCRIPTS + "/graph_to_path.py"], ref, env=env)
    run(f"{sys.executable} {RSCRIPTS}/path_to_contig.py seq_dataset "
        f"p_ctg_tiling_path > p_ctg.fa", ref, env=env)
    print(f"reference draft: {time.time()-t0:.0f}s", flush=True)

    # --- compare ------------------------------------------------------
    mine = dict(read_fastx(base + "/mine/3-asm/p_ctg.fa"))
    refc = dict(read_fastx(ref + "/p_ctg.fa"))
    print(f"contigs mine={ {k: len(v) for k, v in mine.items()} }", flush=True)
    print(f"contigs ref ={ {k: len(v) for k, v in refc.items()} }", flush=True)
    m = max(mine.values(), key=len).upper()
    r = max(refc.values(), key=len).upper()
    best = 0.0
    for cand in (m, revcomp(m)):
        for off in (1000, 5000, 20000):
            p = r.find(cand[off:off+64])
            if p >= 0:
                a = dw_align(cand[off:], r[p:], 2000, get_aln_str=False)
                if a.aln_q_e > len(cand) * 0.5:
                    best = max(best, 1 - a.dist / a.aln_q_e)
                break
    print(f"my-longest vs ref-longest identity: {best:.6f} "
          f"(lens {len(m)} vs {len(r)})", flush=True)
