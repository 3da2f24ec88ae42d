"""E. coli-scale end-to-end run: 4.6 Mb genome, 30x 15 kb reads, 1% error.

Mirrors the reference north-star test shape (test/ecoli_K12/, 40 kb
circular wrap) with a seeded random genome (the real K12 sequence needs
network access).  Usage:

    python scripts/ecoli_scale_run.py [outdir] [--cpu]
"""

import os
import sys
import time

if "--cpu" in sys.argv:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main():
    import jax
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    import logging
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    from peregrine_tpu.config import AsmConfig
    from peregrine_tpu.pipeline.run import Assembly
    from peregrine_tpu.io.seqdb import read_fastx, revcomp
    from simdata import random_genome, simulate_reads

    outdir = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("-") \
        else "/tmp/ecoli_scale_wd"
    rng = np.random.default_rng(42)
    t0 = time.time()
    genome = random_genome(rng, 4_600_000)
    reads, _ = simulate_reads(rng, genome, read_len=15000, coverage=30.0,
                              len_sd=1500, error=0.01, circular_wrap=40000)
    print(f"simulated {len(reads)} reads, "
          f"{sum(len(s) for _, s in reads)/1e6:.0f} Mbases "
          f"({time.time()-t0:.0f}s)", flush=True)

    cfg = AsmConfig(sketch_pad_len=32768, sketch_batch=256)
    asm = Assembly(outdir, cfg)
    stages = []
    for name, fn in (("seqdb", lambda: asm.build_db(reads=reads)),
                     ("index", asm.build_shimmer_index),
                     ("overlap", asm.build_overlaps),
                     ("layout", asm.build_contigs),
                     ("consensus", asm.build_consensus)):
        t0 = time.time()
        fn()
        stages.append((name, time.time() - t0))
        print(f"=== {name}: {stages[-1][1]:.1f}s", flush=True)

    fa = os.path.join(outdir, "4-cns", "p_ctg_cns.fa")
    ctgs = dict(read_fastx(fa))
    print("contigs:", {k: len(v) for k, v in ctgs.items()}, flush=True)

    # identity of the longest contig against the doubled (circular) genome
    from peregrine_tpu.native import dw_align
    g2 = genome + genome
    longest = max(ctgs.values(), key=len)
    for cand, tag in ((longest, "fwd"), (revcomp(longest), "rc")):
        up = cand.upper()
        p = -1
        for off in (1000, 5000, 20000):
            p = g2.find(up[off:off + 64])
            if p >= 0:
                p -= off
                break
        if p < 0:
            continue
        ref = g2[max(p - 200, 0):p + len(up) + 20000]
        aln = dw_align(up, ref, 3000, get_aln_str=False)
        if aln.aln_q_e > len(up) * 0.5:
            print(f"{tag}: aligned {aln.aln_q_e}/{len(up)} dist={aln.dist} "
                  f"identity={1-aln.dist/max(aln.aln_q_e,1):.6f}", flush=True)
            break
    print("stage times:", {n: round(t, 1) for n, t in stages})


if __name__ == "__main__":
    main()
