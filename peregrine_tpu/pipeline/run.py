"""Assembly pipeline orchestrator (the reference's pg_run.py equivalent).

Stages mirror the reference workflow (py/scripts/pg_run.py:571-634) with
file-checkpointed outputs in the reference's directory layout, so any stage
can be inspected, resumed, or cross-validated against reference tools:

    0-seqdb/   seq_dataset.seqdb + .idx
    1-index/   shmr-L{level}-*.dat + MC files
    2-ovlp/    preads.ovl
    3-asm/     sg_edges_list, utg_data, ctg_paths, p_ctg_tiling_path, p_ctg.fa
    4-cns/     p_ctg_cns.fa  (consensus stage)

Unlike the reference (pypeflow DAG of bash tasks over N processes), stages
here run in-process: the sketch/index path executes as batched device
kernels, overlap confirmation through the native aligner, layout on host.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from ..config import AsmConfig
from ..graph.contig import tiling_to_contigs
from ..graph.layout import assemble_graph
from ..graph.string_graph import generate_string_graph
from ..graph.tiling import tiling_paths
from ..io.seqdb import SeqDB, read_fastx
from ..ops.index import ShimmerIndex, build_index
from ..ops.overlap import overlap_all

log = logging.getLogger("peregrine_tpu")

# Batching/padding knobs that change execution shape but not outputs; a
# resume may differ on these without invalidating stage checkpoints.
_NON_SEMANTIC_CFG_FIELDS = frozenset(
    {"sketch_pad_len", "sketch_batch", "aln_batch", "aln_max_len",
     "spill_dir", "device_pairs"})


class ConfigMismatchError(RuntimeError):
    """Raised when resuming an outdir whose config.json disagrees with the
    current AsmConfig on an output-affecting field (reference analog:
    pypeflow re-runs tasks whose declared inputs changed,
    py/scripts/pg_run.py:164-191 — silent reuse of mixed-config stage
    outputs is a correctness trap)."""


def _semantic_cfg_diff(old: AsmConfig, new: AsmConfig) -> dict:
    import dataclasses as _dc
    o, n = _dc.asdict(old), _dc.asdict(new)
    return {k: (o[k], n[k]) for k in o
            if k not in _NON_SEMANTIC_CFG_FIELDS and o.get(k) != n[k]}


def _stage_done(path: str) -> bool:
    return os.path.exists(path)


def _hbm_db_budget(cfg: "AsmConfig | None" = None) -> int:
    """Max packed-db bytes whose device planes may be resident on one
    device at once (override via PG_HBM_DB_BUDGET, in bytes of PACKED
    data, i.e. seqdb bytes — not device bytes).

    The 2-bit+ambiguity planes are ~0.375x the packed bytes, so a budget
    of 0.625x the device allocator's limit (memory_stats()["bytes_limit"])
    keeps the db planes to ~23% of device memory — deliberately
    conservative, because the index/overlap dispatch workspace (sort
    buffers at 9 u32 operands per SHIMMER, the compacted drain prefix,
    and under --device-pairs the on-device pair-map sort) peaks at
    several times the planes on top of them.  Datasets past the budget
    index in segments (ops.index.build_index_segmented).  A backend with
    no allocator limit (CPU) gets a fixed 10 GB.

    With cfg.device_pairs the same device also holds the pair-map sort
    workspace (~9 u32 columns over all SHIMMER hits), so the effective
    db budget is reduced to 60%."""
    env = os.environ.get("PG_HBM_DB_BUDGET")
    if env:
        b = int(env)
    else:
        import jax
        stats = jax.local_devices()[0].memory_stats() or {}
        limit = stats.get("bytes_limit")
        b = int(0.625 * limit) if limit else 10 << 30
    if cfg is not None and cfg.device_pairs:
        b = int(b * 0.6)
    return b


def _hbm_stats_line() -> str:
    """Device memory telemetry ('; HBM in-use/peak GB') when the backend
    exposes allocator stats (GPU does; CPU returns '')."""
    import jax
    st = jax.local_devices()[0].memory_stats()
    if not st:
        return ""
    inuse = st.get("bytes_in_use", 0) / (1 << 30)
    peak = st.get("peak_bytes_in_use", 0) / (1 << 30)
    return f"; HBM {inuse:.1f}/{peak:.1f} GB in-use/peak"


def _mem_budget() -> int:
    """Host anonymous-memory budget in bytes for the overlap stage's
    pair map + request/result caches.  PG_MEM_BUDGET (bytes) overrides;
    the default is 85% of MemAvailable at call time, so the pipeline
    sizes itself to the machine it is on (the reference documents
    running its overlap stage on a 32 GB host, README.md:127-130 — the
    equivalent here is PG_MEM_BUDGET=$((30<<30)) or just a small box)."""
    env = os.environ.get("PG_MEM_BUDGET")
    if env:
        return int(float(env))
    try:
        with open("/proc/meminfo") as f:
            for ln in f:
                if ln.startswith("MemAvailable"):
                    return int(int(ln.split()[1]) * 1024 * 0.85)
    except OSError:
        pass
    return 1 << 62


def _anon_rss_gb() -> float:
    """Current anonymous RSS in GB (RssAnon) — the part of the footprint
    the OS cannot evict; file-backed memmap/spill pages are excluded
    (they inflate VmHWM but fall away under memory pressure)."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("RssAnon"):
                    return int(ln.split()[1]) / (1 << 20)
    except OSError:
        pass
    return 0.0


def _peak_rss_gb() -> float:
    """Process high-water anonymous+file RSS in GB (VmHWM); logged after
    every stage so scale runs record a measured memory budget."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmHWM"):
                    return int(ln.split()[1]) / (1 << 20)
    except OSError:
        pass
    return 0.0


def _spill_free_bytes(spill_dir: str) -> int:
    """Free bytes on the filesystem holding spill_dir (statvfs)."""
    st = os.statvfs(spill_dir)
    return st.f_bavail * st.f_frsize


def _preflight_spill(spill_dir: str, projected: int, what: str) -> None:
    """Fail fast with a sized diagnostic when the spill filesystem cannot
    hold the projected spill bytes, instead of dying mid-write on ENOSPC
    (the 3 Gb rung's first attempt died exactly that way).

    NOTE the projection here is the ON-DISK spill-file peak, NOT the
    2.0x-db anonymous projection that engages auto-spill: spilled
    buffers free progressively, and the measured disk peak at the 3 Gb
    rung was <=10 GB on a 90 GB db (~0.11x) — projected at
    0.22x for margin.  PG_SPILL_PREFLIGHT=0 disables the gate for
    filesystems whose statvfs lies (e.g. some overlay mounts)."""
    if os.environ.get("PG_SPILL_PREFLIGHT", "1") == "0":
        return
    free = _spill_free_bytes(spill_dir)
    if free < projected:
        raise RuntimeError(
            f"spill preflight: {what} projects ~{projected / (1 << 30):.1f} "
            f"GB of spill but {spill_dir} has only {free / (1 << 30):.1f} GB "
            f"free — point --spill-dir at a larger filesystem, free disk, "
            f"or set PG_SPILL_PREFLIGHT=0 to proceed anyway")
    log.info("spill preflight: %s projects ~%.1f GB; %s has %.1f GB free",
             what, projected / (1 << 30), spill_dir, free / (1 << 30))


def _write_lines(path: str, lines) -> None:
    # checkpoint files are written atomically (tmp + rename) so a crash
    # mid-write cannot leave a truncated file that resume trusts
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for ln in lines:
            f.write(ln + "\n")
    os.replace(tmp, path)


class Assembly:
    """Driver holding per-stage state; file outputs double as checkpoints."""

    def __init__(self, outdir: str, cfg: AsmConfig = AsmConfig(),
                 with_alt: bool = False, profile_dir: str | None = None,
                 on_config_change: str = "error"):
        """on_config_change: what to do when outdir holds checkpoints written
        under a semantically different AsmConfig — "error" (refuse),
        "clean" (invalidate stages 1-4 and re-run; stage-0 seqdb is
        config-independent), or "ignore" (trust the caller)."""
        assert on_config_change in ("error", "clean", "ignore")
        self.outdir = outdir
        self.cfg = cfg
        self.with_alt = with_alt
        self.profile_dir = profile_dir  # jax.profiler trace output (optional)
        cfg_path = os.path.join(outdir, "config.json")
        if os.path.exists(cfg_path) and on_config_change != "ignore":
            try:
                old = AsmConfig.from_json(open(cfg_path).read())
            except (TypeError, ValueError):
                old = None  # unreadable/older schema: treat as mismatch
            diff = (_semantic_cfg_diff(old, cfg) if old is not None
                    else {"<config.json>": ("unreadable", "current")})
            if diff:
                if on_config_change == "error":
                    raise ConfigMismatchError(
                        f"{outdir} holds checkpoints built with a different "
                        f"config: {diff}. Pass on_config_change='clean' to "
                        "invalidate stages 1-4, or 'ignore' to proceed.")
                self._invalidate_stages()
                log.warning("config changed (%s): invalidated stage 1-4 "
                            "checkpoints in %s", diff, outdir)
        for d in ("0-seqdb", "1-index", "2-ovlp", "3-asm", "4-cns"):
            os.makedirs(os.path.join(outdir, d), exist_ok=True)
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        self.db: SeqDB | None = None
        self.idx: ShimmerIndex | None = None
        self._save_thread = None  # async stage-0 checkpoint write
        self._pairs = None        # read pair map shared by stages 2 and 4
        self._seqdb_uploader = None  # stage-0 background device upload

    def _invalidate_stages(self) -> None:
        """Remove config-dependent stage checkpoints (1-index through 4-cns
        and the alt-polish dir); the stage-0 seqdb only depends on the reads."""
        import shutil
        for d in ("1-index", "2-ovlp", "3-asm", "4-cns", "4-cns-alt"):
            p = os.path.join(self.outdir, d)
            if os.path.isdir(p):
                shutil.rmtree(p)

    # --- stage 0: sequence database ------------------------------------
    def build_db(self, reads=None, reads_list: str | None = None,
                 reads_iter=None) -> SeqDB:
        prefix = os.path.join(self.outdir, "0-seqdb", "seq_dataset")
        if _stage_done(prefix + ".idx") and reads is None:
            self.db = SeqDB.open(prefix)
        elif reads_iter is not None:
            # in-process (name, seq) stream: bounded-RSS disk build with
            # no FASTA on disk (simulated human-class ladder rungs)
            t0 = time.time()
            self.db = SeqDB.build_to_disk_from_iter(reads_iter, prefix)
            log.info("stage 0 seqdb: %d reads, %d bases (%.1fs streamed "
                     "to disk; peak RSS %.1f GB)", len(self.db),
                     int(self.db.lengths.sum()), time.time() - t0,
                     _peak_rss_gb())
        elif reads is None:
            # manifest input streams straight to disk: peak RSS is one
            # read + the write buffer, not the packed array (90 GB at
            # human-30x scale); the pipeline then reads back through a
            # page-cache-governed memmap.  On an accelerator backend the
            # device seqdb upload runs CONCURRENTLY with the encode via
            # the chunk sink.
            t0 = time.time()
            sink = None
            import jax
            est_bases = 0
            try:
                with open(reads_list) as _lf:
                    for _p in _lf:
                        _p = _p.strip()
                        if _p:
                            est_bases += os.path.getsize(_p)
            except OSError:
                pass
            if jax.default_backend() != "cpu" and not self.cfg.mesh \
                    and est_bases <= _hbm_db_budget(self.cfg):
                # datasets past the device-memory budget index in
                # segments (build_index_segmented); pre-uploading the
                # full plane would exhaust the device
                from ..ops.dbgather import SeqDBUploader
                self._seqdb_uploader = SeqDBUploader()
                sink = self._seqdb_uploader.feed
            self.db = SeqDB.build_to_disk(reads_list, prefix,
                                          chunk_sink=sink)
            log.info("stage 0 seqdb: %d reads, %d bases (%.1fs streamed "
                     "to disk; peak RSS %.1f GB)", len(self.db),
                     int(self.db.lengths.sum()), time.time() - t0,
                     _peak_rss_gb())
        else:
            t0 = time.time()
            self.db = SeqDB.from_reads(reads)
            # the checkpoint write overlaps the index stage: every
            # in-process consumer uses the in-memory db; only the
            # consensus window threads re-open the FILE, so _polish
            # joins this thread first.  save() writes .seqdb before
            # .idx, and resume trusts .idx — a crash mid-write cannot
            # leave a checkpoint that resume believes complete.
            import threading
            self._save_thread = threading.Thread(
                target=self.db.save, args=(prefix,), name="seqdb-save")
            self._save_thread.start()
            log.info("stage 0 seqdb: %d reads, %d bases (%.1fs; "
                     "checkpoint writes in background)",
                     len(self.db), int(self.db.lengths.sum()), time.time() - t0)
        return self.db

    # --- stage 1: SHIMMER index ----------------------------------------
    def build_shimmer_index(self) -> ShimmerIndex:
        prefix = os.path.join(self.outdir, "1-index", "shmr")
        level = self.cfg.levels
        mm = f"{prefix}-L{level}-01-of-01.dat"
        mc = f"{prefix}-L{level}-MC-01-of-01.dat"
        rows = None
        if self._seqdb_uploader is not None:
            rows = self._seqdb_uploader.finish()
            self._seqdb_uploader = None
        if _stage_done(mm):
            self.idx = ShimmerIndex.load_chunks([mm], [mc])
        else:
            t0 = time.time()
            mesh_n = 0
            if self.cfg.mesh:
                import jax
                mesh_n = len(jax.devices())
            if mesh_n > 1:
                from ..parallel.sharded_index import build_index_mesh
                self.idx = build_index_mesh(self.db, self.cfg)
            elif self.db.data.nbytes > _hbm_db_budget(self.cfg):
                import jax
                from ..ops.index import build_index_segmented
                rows = None  # free any pre-uploaded plane first
                if jax.default_backend() != "cpu":
                    log.info("stage 1: db %.1f GB exceeds the HBM budget "
                             "— indexing in segments",
                             self.db.data.nbytes / (1 << 30))
                self.idx = build_index_segmented(self.db, self.cfg,
                                                 _hbm_db_budget(self.cfg))
            else:
                self.idx = build_index(self.db, self.cfg, seqdb_rows=rows)
            self.idx.save(prefix, level=level)
            log.info("stage 1 index: %d SHIMMERs, %d distinct (%.1fs%s; "
                     "peak RSS %.1f GB%s)",
                     len(self.idx.x), len(self.idx.mc_hash), time.time() - t0,
                     f"; mesh of {mesh_n}" if mesh_n > 1 else "",
                     _peak_rss_gb(), _hbm_stats_line())
        return self.idx

    def _pair_map(self):
        """The unchunked oriented read pair map: identical inputs feed the
        overlap stage and the stage-4 mapping (reference recomputes it in
        shmr_overlap AND shmr_map; it costs ~41 s at Drosophila scale), so
        it is built once and shared.  Freed after consensus."""
        if self._pairs is None:
            self._maybe_auto_spill()
            import jax
            mesh_pairs = self.cfg.mesh and len(jax.devices()) > 1
            if mesh_pairs or self.cfg.device_pairs:
                if mesh_pairs:
                    # pod composition: read-sharded build, records ride
                    # the order-preserving hash-range all_to_all.  This
                    # is the --mesh DEFAULT (not opt-in) so the shipped
                    # mesh pipeline is exactly the dryrun_multichip
                    # composition; byte-identity vs the host build is
                    # asserted in tests/test_sharded_pairs.py
                    from ..parallel.sharded_index import make_mesh
                    from ..parallel.sharded_pairs import build_pairs_mesh
                    self._pairs, _ = build_pairs_mesh(
                        self.idx, self.db.lengths, make_mesh(),
                        self.cfg.mc_lower, self.cfg.mc_upper,
                        self.cfg.min_anchor_dist, self.cfg.ovlp_upper)
                else:
                    from ..ops.device_pairs import build_pairs_device
                    self._pairs, _ = build_pairs_device(
                        self.idx, self.db.lengths, self.cfg.mc_lower,
                        self.cfg.mc_upper, self.cfg.min_anchor_dist,
                        self.cfg.ovlp_upper)
            else:
                from ..ops.overlap import build_pairs
                self._pairs = build_pairs(
                    self.idx, self.db.lengths, 1, 1, self.cfg.mc_lower,
                    self.cfg.mc_upper, self.cfg.min_anchor_dist,
                    spill_dir=self.cfg.spill_dir)
        return self._pairs

    def _maybe_auto_spill(self) -> None:
        """Self-sizing low-memory mode: when the projected anonymous
        footprint of the overlap stage (pair map + request/result
        caches) exceeds the host budget, back those buffers with
        unlinked spill files automatically instead of requiring the
        opt-in --spill-dir flag.

        The projection is the measured scaling of the anonymous bulk:
        ~2.0x the packed db bytes (250 Mb reads: ~10-12 GB anon on a
        7.5 GB db; 500 Mb: ~26-28 GB on 15 GB; 1 Gb: ~55-60 GB on
        28 GB at the scale-ladder rungs).  Reference analog: the overlap
        stage is documented to run on a 32 GB machine
        (reference README.md:127-130)."""
        if self.cfg.spill_dir is not None or self.db is None:
            return
        projected = int(2.0 * self.db.data.nbytes)
        budget = _mem_budget()
        if projected <= budget:
            return
        import dataclasses
        d = os.path.join(self.outdir, "spill")
        os.makedirs(d, exist_ok=True)
        _preflight_spill(d, int(0.22 * self.db.data.nbytes),
                         "auto-spill (overlap stage)")
        self.cfg = dataclasses.replace(self.cfg, spill_dir=d)
        log.info("auto-spill: projected overlap anon ~%.1f GB exceeds "
                 "the %.1f GB budget (PG_MEM_BUDGET/MemAvailable) — "
                 "pair map + overlap caches spill to %s",
                 projected / (1 << 30), budget / (1 << 30), d)

    # --- stage 2: overlaps ---------------------------------------------
    def build_overlaps(self, n_chunks: int | None = None,
                       n_workers: int | None = None) -> str:
        path = os.path.join(self.outdir, "2-ovlp", "preads.ovl")
        if not _stage_done(path):
            t0 = time.time()
            self._maybe_auto_spill()
            if self.cfg.spill_dir is not None and self.db is not None:
                # explicit --spill-dir: same capacity gate auto-spill gets
                os.makedirs(self.cfg.spill_dir, exist_ok=True)
                _preflight_spill(self.cfg.spill_dir,
                                 int(0.22 * self.db.data.nbytes),
                                 "overlap stage spill")
            dedup = self.cfg.dedup_overlap
            if self.cfg.use_device_aligner or self.cfg.hybrid_overlap:
                log.warning(
                    "non-host overlap backend: the device Myers kernel "
                    "reports optimal distances where the host aligner is "
                    "greedy, so accept decisions differ slightly (~97.5%% "
                    "pair agreement); output is not byte-identical to the "
                    "host backend")
            if self.cfg.hybrid_overlap and dedup:
                # chunk-free hybrid: host threads + a device thread pull
                # slices of ONE globally-deduplicated request array
                from ..ops.overlap import overlap_all_spec
                ovlps = overlap_all_spec(
                    self.db, self.idx, self.cfg,
                    n_workers=n_workers or (os.cpu_count() or 1),
                    backend="hybrid", pairs=self._pair_map())
            elif self.cfg.hybrid_overlap:
                import jax
                from ..ops.overlap import overlap_all_hybrid
                if jax.default_backend() == "cpu":
                    log.warning("hybrid overlap requested without an "
                                "accelerator; using host chunks only")
                n_workers = n_workers or (os.cpu_count() or 1)
                # one chunk per worker thread (host threads + the device
                # thread): every EXTRA chunk duplicates 55-80% of a
                # chunk's alignments (per-chunk rid-pair dedup)
                ovlps = overlap_all_hybrid(
                    self.db, self.idx, self.cfg,
                    n_chunks=n_chunks or (n_workers + 1),
                    n_host_workers=n_workers)
            elif self.cfg.use_device_aligner and dedup \
                    and not self.cfg.shard_overlap:
                from ..ops.overlap import overlap_all_spec
                ovlps = overlap_all_spec(self.db, self.idx, self.cfg,
                                         n_workers=n_workers,
                                         backend="device",
                                         pairs=self._pair_map())
            elif dedup and self.cfg.spill_dir is not None \
                    and not self.cfg.shard_overlap:
                # low-memory mode: sharing the stage-2/stage-4 pair map
                # pins its ~33 B/entry spill file on disk across stages
                # 2-4 (~11 GB at the human-class rung, on top of the
                # replay stream + result arena the overlap rounds
                # themselves spill).  Share it only when the spill
                # filesystem has the extra headroom; otherwise let
                # overlap_all_spec build and free its own copy and
                # stage 4 rebuilds.
                from ..ops.overlap import overlap_all_spec
                free = _spill_free_bytes(self.cfg.spill_dir)
                # pinning the map costs ~0.13x db of disk across stages
                # 2-4, on top of ~0.11x transient spill and ~0.25x of
                # stage-3/4 outputs still to come (measured at the 3 Gb
                # rung) — require 0.55x db free
                keep_map = free >= int(0.55 * self.db.data.nbytes)
                log.info("overlap spill mode: %s the stage-2/4 pair map "
                         "(spill free %.1f GB vs %.1f GB to keep it)",
                         "sharing" if keep_map else "not sharing",
                         free / (1 << 30),
                         0.55 * self.db.data.nbytes / (1 << 30))
                ovlps = overlap_all_spec(
                    self.db, self.idx, self.cfg,
                    n_workers=n_workers or (os.cpu_count() or 1),
                    backend="host",
                    pairs=self._pair_map() if keep_map else None)
            elif self.cfg.use_device_aligner:
                from ..ops.overlap import overlap_chunk_device
                if n_chunks or n_workers:
                    log.warning("device aligner runs in-process; "
                                "n_chunks/n_workers ignored")
                ovlps = overlap_chunk_device(self.db, self.idx, self.cfg,
                                             batch=self.cfg.aln_batch)
            else:
                if n_workers is None:
                    n_workers = 1 if len(self.db) < 2000 else (os.cpu_count() or 1)
                n_chunks = n_chunks or n_workers
                level = self.cfg.levels
                prefix = os.path.join(self.outdir, "1-index", "shmr")
                ovlps = overlap_all(
                    self.db, self.idx, self.cfg,
                    n_chunks=n_chunks, n_workers=n_workers,
                    seqdb_prefix=os.path.join(self.outdir, "0-seqdb", "seq_dataset"),
                    mm_paths=[f"{prefix}-L{level}-01-of-01.dat"],
                    mc_paths=[f"{prefix}-L{level}-MC-01-of-01.dat"],
                    pairs=(self._pair_map()
                           if self.cfg.dedup_overlap and n_workers > 1
                           else None))
            from ..ops.overlap import write_ovl_file
            n_rows = write_ovl_file(path, ovlps)
            spill_line = ""
            if self.cfg.spill_dir is not None:
                spill_line = (", spill free %.1f GB"
                              % (_spill_free_bytes(self.cfg.spill_dir)
                                 / (1 << 30)))
            log.info("stage 2 overlap: %d records -> %d rows (%.1fs; "
                     "peak RSS %.1f GB, anon %.1f GB%s%s)",
                     len(ovlps), n_rows, time.time() - t0, _peak_rss_gb(),
                     _anon_rss_gb(), _hbm_stats_line(), spill_line)
        return path

    # --- stage 3: layout + draft contigs --------------------------------
    def build_contigs(self) -> str:
        asm = os.path.join(self.outdir, "3-asm")
        fa = os.path.join(asm, "p_ctg.fa")
        if _stage_done(fa):
            return fa
        t0 = time.time()
        with open(os.path.join(self.outdir, "2-ovlp", "preads.ovl"),
                  "rb") as f:
            result = generate_string_graph(
                ovl_bytes=f.read(), min_len=self.cfg.min_len,
                min_idt=self.cfg.min_idt, lfc=self.cfg.lfc,
                disable_chimer_bridge_removal=self.cfg.disable_chimer_bridge_removal)
        sg_path = os.path.join(asm, "sg_edges_list")
        if result.sg_edge_bytes is not None:
            with open(sg_path + ".tmp", "wb") as f:
                f.write(result.sg_edge_bytes)
            os.replace(sg_path + ".tmp", sg_path)
        else:
            _write_lines(sg_path, result.sg_edge_lines)
        _write_lines(os.path.join(asm, "chimers_nodes"), result.chimer_nodes)

        u_edge_data, ctg_rows, utg_rows, compound_rows = assemble_graph(result)
        _write_lines(os.path.join(asm, "utg_data"), utg_rows)
        _write_lines(os.path.join(asm, "ctg_paths"), ctg_rows)
        _write_lines(os.path.join(asm, "c_path"), compound_rows)

        p_lines, a_lines = tiling_paths(result.sg_edge_lines, utg_rows,
                                        ctg_rows,
                                        edge_data=result.tiling_edge_data())
        _write_lines(os.path.join(asm, "p_ctg_tiling_path"), p_lines)
        _write_lines(os.path.join(asm, "a_ctg_tiling_path"), a_lines)

        contigs = tiling_to_contigs(self.db, p_lines)
        with open(fa + ".tmp", "w") as f:
            for name, seq in contigs:
                f.write(f">{name}\n{seq.decode()}\n")
        os.replace(fa + ".tmp", fa)
        if self.with_alt and a_lines:
            # alternate (bubble-branch) contigs, reference --with-alt
            # (py/scripts/pg_run.py:359-371)
            a_contigs = tiling_to_contigs(self.db, a_lines)
            with open(os.path.join(asm, "a_ctg.fa"), "w") as f:
                for name, seq in a_contigs:
                    f.write(f">{name}\n{seq.decode()}\n")
        log.info("stage 3 layout: %d contigs, %d bases (%.1fs; "
                 "peak RSS %.1f GB)",
                 len(contigs), sum(len(s) for _, s in contigs),
                 time.time() - t0, _peak_rss_gb())
        return fa

    # --- stage 4: mapping + consensus polish ----------------------------
    def build_consensus(self, n_workers: int | None = None) -> str:
        out = self._polish("p_ctg.fa", "4-cns", "p_ctg_cns.fa", n_workers)
        if self.with_alt:
            # alt-contig polish pass: reference reruns the whole consensus
            # stage against a_ctg.fa when it is non-trivial (>500 kB)
            # (py/scripts/pg_run.py:622-633)
            a_fa = os.path.join(self.outdir, "3-asm", "a_ctg.fa")
            if (os.path.exists(a_fa)
                    and os.stat(a_fa).st_size > self.cfg.alt_cns_min_size):
                self._polish("a_ctg.fa", "4-cns-alt", "a_ctg_cns.fa",
                             n_workers)
        self._pairs = None  # free the shared pair map (GBs at scale)
        return out

    def _polish(self, ctg_fa: str, cns_subdir: str, out_name: str,
                n_workers: int | None = None) -> str:
        from ..ops.consensus import consensus_for_contig, consensus_parallel
        from ..ops.mapping import map_reads_to_ref

        cns_dir = os.path.join(self.outdir, cns_subdir)
        os.makedirs(cns_dir, exist_ok=True)
        out_fa = os.path.join(cns_dir, out_name)
        if _stage_done(out_fa):
            return out_fa
        t0 = time.time()
        ctg_prefix = os.path.join(cns_dir, "ctg")
        ctg_db = SeqDB.from_reads(
            read_fastx(os.path.join(self.outdir, "3-asm", ctg_fa)))
        ctg_db.save(ctg_prefix)
        t_db = time.time()
        ctg_idx = build_index(ctg_db, self.cfg)
        t_idx = time.time()
        log.info("stage 4 phase walls: ctg db %.1fs, ctg index %.1fs"
                 "%s", t_db - t0, t_idx - t_db,
                 "" if self._pairs is not None
                 else " (pair map rebuild follows)")
        from ..native import write_rows
        # external grouped emission bounds this stage's anonymous peak
        # (the reference's `sort -T tmp -S 8g` analog,
        # py/scripts/pg_run.py:491-496): rows land grouped by contig in
        # a disk-backed memmap; per-contig content and order match the
        # in-memory path exactly (tests/test_mapping.py), only the
        # diagnostic read_map.txt row order differs (grouped vs walk)
        external = (os.environ.get("PG_MAP_EXTERNAL") == "1"
                    or self.db.data.nbytes > (8 << 30))
        if external:
            from ..ops.mapping import map_reads_to_ref_grouped
            mm, offs = map_reads_to_ref_grouped(
                self.idx, self.db.lengths, ctg_idx, self.cfg,
                os.path.join(cns_dir, "read_map.npy"), len(ctg_db),
                pairs=self._pairs)
            # per-contig offsets persist beside the grouped rows so any
            # process (multihost consensus ranks, resume) can re-open the
            # mapping without recomputing it
            np.save(os.path.join(cns_dir, "read_map_offs.npy"), offs)
            if os.environ.get("PG_SKIP_MAP_TXT") != "1":
                # read_map.txt is a diagnostic mirror of read_map.npy
                # (shmr_map's text output); at the human-class rung it
                # costs ~5 GB of scarce disk, so allow opting out
                write_rows(mm, os.path.join(cns_dir, "read_map.txt"))
            n_rows = len(mm)
            contig_rows = {rid: mm[offs[rid]:offs[rid + 1]]
                           for rid in range(len(ctg_db))}
        else:
            rows = map_reads_to_ref(self.idx, self.db.lengths, ctg_idx,
                                    self.cfg, pairs=self._pairs)
            write_rows(rows.reshape(len(rows), -1),
                       os.path.join(cns_dir, "read_map.txt"))
            n_rows = len(rows)
            contig_rows = {rid: (rows[rows[:, 0] == rid]
                                 if len(rows) else rows)
                           for rid in range(len(ctg_db))}
        log.info("stage 4 mapping: %d rows (%.1fs%s)", n_rows,
                 time.time() - t0, "; external grouped" if external else "")

        if n_workers is None:
            # consensus workers are GIL-releasing threads (ops.consensus
            # .consensus_parallel) — no spawn tax, so always parallel
            n_workers = os.cpu_count() or 1
        if self._save_thread is not None:
            # the window threads re-open the seqdb from disk
            self._save_thread.join()
            self._save_thread = None
        if n_workers > 1:
            seqs = consensus_parallel(
                os.path.join(self.outdir, "0-seqdb", "seq_dataset"),
                ctg_prefix, contig_rows, ctg_db.lengths, self.cfg, n_workers)
        else:
            seqs = {rid: consensus_for_contig(self.db, ctg_db, rid,
                                              contig_rows[rid], self.cfg)
                    for rid in range(len(ctg_db))}
        with open(out_fa + ".tmp", "w") as f:
            for ctg_rid in range(len(ctg_db)):
                f.write(f">{ctg_db.names[ctg_rid]}\n"
                        f"{seqs[ctg_rid].decode()}\n")
        os.replace(out_fa + ".tmp", out_fa)
        log.info("stage 4 consensus done (%.1fs; peak RSS %.1f GB, "
                 "anon %.1f GB%s)",
                 time.time() - t0, _peak_rss_gb(), _anon_rss_gb(),
                 _hbm_stats_line())
        return out_fa

    def run_draft(self, reads=None, reads_list: str | None = None) -> str:
        """Stages 0-3: reads -> draft p_ctg.fa."""
        self.build_db(reads, reads_list)
        self.build_shimmer_index()
        self.build_overlaps()
        return self.build_contigs()

    def _mh_overlap(self, rank: int, nranks: int, barrier) -> None:
        """Stage 2 with the alignment rounds sharded across ranks
        (reference analog: N shmr_overlap processes
        over a shared filesystem, py/scripts/pg_run.py:320-342).

        Every rank runs the identical deterministic collect loop
        (overlap_all_spec); rank r aligns only its block-cyclic share of
        each round's request buffer, results ride the shared filesystem
        (exchange files + a device barrier per round), every rank merges
        the identical full result set, and the final exact replay runs
        on rank 0 only — so preads.ovl is byte-identical to the
        single-process run at ANY rank count."""
        from ..ops.overlap import overlap_all_spec, write_ovl_file

        path = os.path.join(self.outdir, "2-ovlp", "preads.ovl")
        xdir = os.path.join(self.outdir, "2-ovlp", "xchg")
        os.makedirs(xdir, exist_ok=True)
        self._maybe_auto_spill()

        def exchange(rnd: int, reqs, res, mine):
            my_idx = np.flatnonzero(mine)
            p = os.path.join(xdir, f"res-r{rnd}-p{rank}.npz")
            np.savez(p + ".tmp.npz", idx=my_idx, res=res[my_idx],
                     n=np.int64(len(res)))
            os.replace(p + ".tmp.npz", p)
            barrier(f"pg-tpu ovl-xchg-{rnd}")
            for r in range(nranks):
                if r == rank:
                    continue
                with np.load(os.path.join(
                        xdir, f"res-r{rnd}-p{r}.npz")) as d:
                    if int(d["n"]) != len(res):
                        raise RuntimeError(
                            f"overlap exchange round {rnd}: rank {r} "
                            f"collected {int(d['n'])} requests vs local "
                            f"{len(res)} — ranks diverged")
                    res[d["idx"]] = d["res"]
            return res

        t0 = time.time()
        n_workers = os.cpu_count() or 1
        ovlps = overlap_all_spec(
            self.db, self.idx, self.cfg, n_workers=n_workers,
            backend="host", pairs=None, shard=(rank, nranks),
            exchange=exchange, run_final=(rank == 0))
        if rank == 0:
            n_rows = write_ovl_file(path, ovlps)
            log.info("stage 2 overlap [multihost x%d]: %d records -> %d "
                     "rows (%.1fs on rank 0)", nranks, len(ovlps), n_rows,
                     time.time() - t0)
            import shutil
            shutil.rmtree(xdir, ignore_errors=True)

    def _mh_consensus(self, rank: int, nranks: int, barrier,
                      n_workers: int | None = None) -> str:
        """Stage 4 with consensus windows sharded by job index % nranks
        (the reference's own scheme one grain finer — pg_asm_cns.py:59
        shards whole contigs).  Rank 0 maps reads to contigs (external
        grouped emission → read_map.npy + read_map_offs.npy on the
        shared FS), every rank computes its window share, segment bytes
        ride exchange files, rank 0 stitches and writes — byte-identical
        to the single-process consensus."""
        import pickle

        from ..ops.consensus import consensus_windows, plan_all, stitch_all

        cns_dir = os.path.join(self.outdir, "4-cns")
        out_fa = os.path.join(cns_dir, "p_ctg_cns.fa")
        if _stage_done(out_fa):
            return out_fa
        if rank == 0:
            # rank 0 runs the mapping and persists the grouped rows
            # (external emission, so peers can mmap the identical columns)
            self._ensure_mapping()
        barrier("pg-tpu stage4-map")

        t0 = time.time()
        ctg_prefix = os.path.join(cns_dir, "ctg")
        ctg_db = SeqDB.open(ctg_prefix)
        mm = np.load(os.path.join(cns_dir, "read_map.npy"), mmap_mode="r")
        offs = np.load(os.path.join(cns_dir, "read_map_offs.npy"))
        contig_rows = {rid: mm[offs[rid]:offs[rid + 1]]
                       for rid in range(len(ctg_db))}
        plans = plan_all(contig_rows, ctg_db.lengths, self.cfg)
        if n_workers is None:
            n_workers = os.cpu_count() or 1
        if self._save_thread is not None:
            # the window threads re-open the seqdb from disk
            self._save_thread.join()
            self._save_thread = None
        read_db = SeqDB.open(
            os.path.join(self.outdir, "0-seqdb", "seq_dataset"))
        part = consensus_windows(read_db, ctg_db, plans, self.cfg,
                                 n_workers, shard=(rank, nranks))
        n_windows = sum(len(s) for s in plans.values())
        log.info("stage 4 consensus [multihost]: rank %d computed %d of "
                 "%d windows (%.1fs)", rank, len(part), n_windows,
                 time.time() - t0)
        xdir = os.path.join(cns_dir, "xchg")
        os.makedirs(xdir, exist_ok=True)
        p = os.path.join(xdir, f"cns-p{rank}.pkl")
        with open(p + ".tmp", "wb") as f:
            pickle.dump(part, f)
        os.replace(p + ".tmp", p)
        barrier("pg-tpu stage4-cns")
        if rank != 0:
            return out_fa
        results = dict(part)
        for r in range(1, nranks):
            with open(os.path.join(xdir, f"cns-p{r}.pkl"), "rb") as f:
                results.update(pickle.load(f))
        seqs = stitch_all(plans, results)
        with open(out_fa + ".tmp", "w") as f:
            for ctg_rid in range(len(ctg_db)):
                f.write(f">{ctg_db.names[ctg_rid]}\n"
                        f"{seqs[ctg_rid].decode()}\n")
        os.replace(out_fa + ".tmp", out_fa)
        import shutil
        shutil.rmtree(xdir, ignore_errors=True)
        log.info("stage 4 consensus done [multihost x%d]", nranks)
        return out_fa

    def _ensure_mapping(self) -> None:
        """Run the stage-4 mapping (ctg seqdb/index + grouped emission)
        if its outputs are not already on disk — the shared-FS input of
        the multihost consensus ranks."""
        cns_dir = os.path.join(self.outdir, "4-cns")
        os.makedirs(cns_dir, exist_ok=True)
        if _stage_done(os.path.join(cns_dir, "read_map_offs.npy")):
            return
        from ..ops.index import build_index
        from ..ops.mapping import map_reads_to_ref_grouped
        t0 = time.time()
        ctg_prefix = os.path.join(cns_dir, "ctg")
        ctg_db = SeqDB.from_reads(
            read_fastx(os.path.join(self.outdir, "3-asm", "p_ctg.fa")))
        ctg_db.save(ctg_prefix)
        ctg_idx = build_index(ctg_db, self.cfg)
        mm, offs = map_reads_to_ref_grouped(
            self.idx, self.db.lengths, ctg_idx, self.cfg,
            os.path.join(cns_dir, "read_map.npy"), len(ctg_db),
            pairs=self._pairs)
        tmp = os.path.join(cns_dir, "read_map_offs.npy.tmp.npy")
        np.save(tmp, offs)
        os.replace(tmp, os.path.join(cns_dir, "read_map_offs.npy"))
        log.info("stage 4 mapping: %d rows (%.1fs; external grouped)",
                 len(mm), time.time() - t0)

    def run_multihost(self, reads_list: str, with_consensus: bool = False
                      ) -> str | None:
        """Multi-process pipeline over a shared filesystem (the mesh analog
        of the reference's chunk-process fan-out,
        py/scripts/pg_run.py:254-342 + README multi-machine guidance).

        Every process must have called jax.distributed.initialize
        (parallel.distributed.init_distributed) first.  Work
        distribution per stage:

          0 seqdb    rank 0 (streamed native encode; IO-bound)
          1 index    ALL ranks over the global device mesh (data-parallel
                     sketch + hash all_to_all + replicating gather)
          2 overlap  ALL ranks — alignment rounds sharded block-cyclically
                     (``_mh_overlap``), results exchanged per round over
                     the shared FS; final exact replay on rank 0
          3 layout   rank 0 (serial string graph, same as the reference)
          4 mapping  rank 0; consensus windows sharded across ALL ranks
                     (``_mh_consensus``)

        Every stage output is byte-identical to the single-process run
        at any rank count (scripts/multihost_pipeline.py asserts this
        for 2 processes e2e).  Returns the final fasta path on rank 0,
        None elsewhere."""
        import jax
        from jax.experimental import multihost_utils

        from ..parallel.sharded_index import build_index_mesh, make_mesh

        rank = jax.process_index()
        nranks = jax.process_count()
        primary = rank == 0
        barrier = multihost_utils.sync_global_devices
        if primary:
            self.build_db(reads_list=reads_list)
        barrier("pg-tpu stage0")
        if not primary:
            self.db = SeqDB.open(
                os.path.join(self.outdir, "0-seqdb", "seq_dataset"))

        prefix = os.path.join(self.outdir, "1-index", "shmr")
        level = self.cfg.levels
        mm = f"{prefix}-L{level}-01-of-01.dat"
        if _stage_done(mm):
            self.idx = ShimmerIndex.load_chunks(
                [mm], [f"{prefix}-L{level}-MC-01-of-01.dat"])
        else:
            t0 = time.time()
            mesh = make_mesh()  # the global (possibly multi-host) mesh
            self.idx = build_index_mesh(self.db, self.cfg, mesh=mesh)
            if primary:
                self.idx.save(prefix, level=level)
                log.info("stage 1 index [multihost x%d over %d devices]: "
                         "%d SHIMMERs (%.1fs)", nranks,
                         len(jax.devices()), len(self.idx.x),
                         time.time() - t0)
        barrier("pg-tpu stage1")

        if not _stage_done(os.path.join(self.outdir, "2-ovlp",
                                        "preads.ovl")):
            if nranks > 1:
                self._mh_overlap(rank, nranks, barrier)
            elif primary:
                self.build_overlaps()
        barrier("pg-tpu stage2")

        fa = None
        if primary:
            fa = self.build_contigs()
        barrier("pg-tpu stage3")

        if with_consensus:
            if nranks > 1:
                out = self._mh_consensus(rank, nranks, barrier)
                if primary:
                    fa = out
            elif primary:
                fa = self.build_consensus()
        barrier("pg-tpu final")
        return fa if primary else None

    def run(self, reads=None, reads_list: str | None = None,
            with_consensus: bool = True) -> str:
        """Full pipeline; returns the final fasta path."""
        if self.profile_dir:
            import jax
            jax.profiler.start_trace(self.profile_dir)
        try:
            fa = self.run_draft(reads, reads_list)
            if with_consensus:
                fa = self.build_consensus()
        finally:
            if self.profile_dir:
                import jax
                jax.profiler.stop_trace()
        return fa


def assemble(reads=None, reads_list: str | None = None, outdir: str = "./wd",
             cfg: AsmConfig = AsmConfig()) -> str:
    """One-call draft assembly; returns the p_ctg.fa path."""
    return Assembly(outdir, cfg).run_draft(reads, reads_list)
