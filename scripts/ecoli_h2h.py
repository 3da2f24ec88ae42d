"""Literal ecoli_K12 head-to-head (VERDICT r3 item 7).

Runs the reference's OWN bundled test recipe at its full 4.6 Mb shape:
the read simulator `test/ecoli_K12/simulate_reads.py` is executed
VERBATIM (seed 42, 8 read files, 1% indel-biased error model), and the
identical reads feed both full pipelines:

  reference: shmr_mkseqdb -> shmr_index -> shmr_overlap -> shmr_dedup
             -> ovlp_to_graph/graph_to_path/path_to_contig
             -> p_ctg seqdb/index -> shmr_map -> pg_asm_cns
             (the run_test.sh recipe, single-chunk: chunked and 1-chunk
             outputs differ only in record order, see BENCH.md r2)
  mine:      Assembly.run_draft + build_consensus

The genuine K12MG1655.fa is a wget in the reference Makefile (no
network egress here), so a seeded random genome of the true K12 length
(4,641,652 bp) + the simulator's own 40 kb circular wrap stands in —
the simulator itself runs unmodified.

Identity is measured with the exact full-coverage verifier
(peregrine_tpu/verify.py — true Levenshtein distance, dnadiff-style
1-to-1 but with no skipped bases): each consensus vs the truth genome,
and mine vs reference mutually.  Report written to
docs_logs_r4/ECOLI_H2H.md.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

K12_LEN = 4_641_652
BASE = "/tmp/ecoli_h2h"
RSCRIPTS = "/root/reference/py/scripts"
SIM = "/root/reference/test/ecoli_K12/simulate_reads.py"


def run(cmd, cwd, env=None):
    r = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                       shell=isinstance(cmd, str), env=env)
    if r.returncode != 0:
        print("FAILED:", cmd, "\n", r.stderr[-2000:], flush=True)
        raise SystemExit(1)
    return r


def k12_like_genome(rng, np):
    """K12-shaped repeat content (VERDICT r4 item 2: the real K12 carries
    ~7 rRNA operons of ~5 kb at near-identity plus dispersed IS
    elements): a 4.64 Mb backbone with 7 pasted ~5 kb operon copies at
    ~99.5% identity and 20 ~1.2 kb IS copies at ~97%."""
    from simdata import mutate, random_genome
    backbone = bytearray(random_genome(rng, K12_LEN))
    rrn = random_genome(rng, 5000)
    is_el = random_genome(rng, 1200)
    for unit, n_cp, div in ((rrn, 7, 0.005), (is_el, 20, 0.03)):
        for p in sorted(rng.integers(50_000, K12_LEN - 10_000,
                                     n_cp).tolist()):
            copy = mutate(rng, unit, div)
            backbone[p:p + len(copy)] = copy
    return bytes(backbone)


def main():
    global BASE
    repeats = "--repeats" in sys.argv
    if repeats:
        BASE = "/tmp/ecoli_h2h_rep"
    import numpy as np

    from refbuild import ensure_ref_build
    from simdata import random_genome
    from peregrine_tpu.config import AsmConfig
    from peregrine_tpu.io.seqdb import read_fastx
    from peregrine_tpu.pipeline.run import Assembly
    from peregrine_tpu.verify import verify_contig

    ref_build = ensure_ref_build(with_py=True)
    assert ref_build, "reference build unavailable"

    os.makedirs(BASE, exist_ok=True)
    rng = np.random.default_rng(1655)
    genome = k12_like_genome(rng, np) if repeats \
        else random_genome(rng, K12_LEN)
    if repeats:
        print("repeat-bearing K12 stand-in: 7x ~5 kb rRNA-like operons "
              "@99.5% identity + 20x ~1.2 kb IS elements @97%", flush=True)
    with open(os.path.join(BASE, "K12MG1655.fa"), "w") as f:
        f.write(">K12MG1655_simulated\n")
        for i in range(0, len(genome), 80):
            f.write(genome[i:i + 80].decode() + "\n")

    # --- the reference's own simulator, verbatim -----------------------
    t0 = time.time()
    os.makedirs(os.path.join(BASE, "reads"), exist_ok=True)
    if not os.path.exists(os.path.join(BASE, "reads", "reads_7.fa")):
        run([sys.executable, SIM], cwd=BASE)
    lst = os.path.join(BASE, "seq_dataset.lst")
    with open(lst, "w") as f:
        for j in range(8):
            f.write(os.path.join(BASE, "reads", f"reads_{j}.fa") + "\n")
    n_bases = sum(os.path.getsize(os.path.join(BASE, "reads", f"reads_{j}.fa"))
                  for j in range(8))
    print(f"simulated reads: ~{n_bases/1e6:.0f} MB across 8 files "
          f"({time.time()-t0:.0f}s)", flush=True)

    # --- mine ----------------------------------------------------------
    t0 = time.time()
    asm = Assembly(os.path.join(BASE, "mine"),
                   AsmConfig(sketch_pad_len=32768, sketch_batch=256))
    asm.run_draft(reads_list=lst)
    mine_cns_fa = asm.build_consensus()
    t_mine = time.time() - t0
    print(f"mine (draft+cns): {t_mine:.0f}s", flush=True)

    # --- reference (run_test.sh recipe, single chunk) ------------------
    t0 = time.time()
    ref = os.path.join(BASE, "ref")
    os.makedirs(ref, exist_ok=True)
    env = dict(os.environ, PYTHONHASHSEED="0")
    if not os.path.exists(os.path.join(ref, "p_ctg_cns.fa")):
        run([ref_build + "/shmr_mkseqdb", "-p", "seq_dataset", "-d", lst], ref)
        run([ref_build + "/shmr_index", "-p", "seq_dataset", "-r", "6",
             "-t", "1", "-c", "1", "-o", "shmr"], ref)
        run([ref_build + "/shmr_overlap", "-p", "seq_dataset",
             "-l", "shmr-L2", "-t", "1", "-c", "1", "-o", "ovlp.01"], ref)
        run(f"{ref_build}/shmr_dedup < ovlp.01 > preads.ovl && "
            "echo - >> preads.ovl", ref)
        run([sys.executable, RSCRIPTS + "/ovlp_to_graph.py"], ref, env=env)
        run([sys.executable, RSCRIPTS + "/graph_to_path.py"], ref, env=env)
        run(f"{sys.executable} {RSCRIPTS}/path_to_contig.py seq_dataset "
            f"p_ctg_tiling_path > p_ctg.fa", ref, env=env)
        with open(os.path.join(ref, "p_ctg.lst"), "w") as f:
            f.write(os.path.join(ref, "p_ctg.fa") + "\n")
        run([ref_build + "/shmr_mkseqdb", "-p", "p_ctg",
             "-d", "p_ctg.lst"], ref)
        run([ref_build + "/shmr_index", "-p", "p_ctg", "-r", "6",
             "-t", "1", "-c", "1", "-o", "p_ctg"], ref)
        run(f"{ref_build}/shmr_map -r p_ctg -m p_ctg-L2 -p seq_dataset "
            f"-l shmr-L2 -t 1 -c 1 > read_map.txt", ref)
        run(f"{sys.executable} {RSCRIPTS}/pg_asm_cns.py seq_dataset p_ctg "
            f"read_map.txt 1 1 > p_ctg_cns.fa", ref, env=env)
    t_ref = time.time() - t0
    print(f"reference (draft+cns): {t_ref:.0f}s", flush=True)

    # --- exact identity report ----------------------------------------
    mine = dict(read_fastx(mine_cns_fa))
    refc = dict(read_fastx(os.path.join(ref, "p_ctg_cns.fa")))
    m = bytes(max(mine.values(), key=len)).upper()
    r = bytes(max(refc.values(), key=len)).upper()
    rows = []
    for tag, contig, truth in (
            ("mine_cns vs truth", m, genome),
            ("ref_cns vs truth", r, genome),
            ("mine_cns vs ref_cns", m, r)):
        v = verify_contig(contig, truth, circular=True)
        if not v.get("anchored"):
            rows.append((tag, len(contig), "-", "unanchored"))
            continue
        rows.append((tag, v["length"], v["distance"],
                     f"{v['identity']:.7f}"))
        print(f"{tag}: dist={v['distance']} over {v['length']:,} "
              f"identity={v['identity']:.7f}", flush=True)

    rep_dir = os.path.join(os.path.dirname(__file__), "..", "docs_logs_r4")
    os.makedirs(rep_dir, exist_ok=True)
    rep = os.path.join(rep_dir,
                       "ECOLI_H2H_REPEATS.md" if repeats
                       else "ECOLI_H2H.md")
    with open(rep, "w") as f:
        f.write(
            "# Literal ecoli_K12 head-to-head (reference's own simulator, "
            "seed 42)\n\n"
            f"Genome: seeded "
            f"{'REPEAT-BEARING (7x ~5 kb rRNA-like operons @99.5% + 20x IS @97%)' if repeats else 'random'} "
            f"stand-in at the true K12MG1655 length "
            f"({K12_LEN:,} bp; the genuine FASTA is a wget in the "
            "reference Makefile — no egress here).  Reads: "
            "`test/ecoli_K12/simulate_reads.py` run VERBATIM (8 files, "
            "~16x, 1% error).  Reference pipeline: run_test.sh recipe "
            "single-chunk incl. pg_asm_cns consensus.\n\n"
            f"Walls: mine {t_mine:.0f}s, reference {t_ref:.0f}s "
            "(same 2-core host; both include consensus).\n\n"
            "| comparison | contig len | exact dist | identity |\n"
            "|---|---|---|---|\n")
        for tag, ln, d, idt in rows:
            f.write(f"| {tag} | {ln:,} | {d} | {idt} |\n")
        f.write("\nIdentity = exact full-coverage Levenshtein "
                "(peregrine_tpu/verify.py), strictly stronger than "
                "dnadiff block identity.\n")
    print("report written:", os.path.abspath(rep), flush=True)

    # regression gate (make check): every comparison must anchor and
    # reach the BASELINE mutual-identity bar
    bad = [t for t, _, d, idt in rows
           if idt == "unanchored" or float(idt) < 0.999]
    if bad:
        print("GATE FAILED:", bad, flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
