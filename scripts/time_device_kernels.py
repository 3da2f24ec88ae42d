"""Time the device kernels of the main path on a GPU.

    python scripts/time_device_kernels.py

Prints the card (nvidia-smi name and power limit), then:

* index_step (sketch -> L1 -> L2, w=80 k=16 r=6, cap = L/8) at the
  pipeline's pad class for 15 kb reads, [256, 16384], and at the
  throughput shape [8192, 32768], in padded Mbases/s;
* the banded Myers aligner (myers_batch, nb=8) on 1,024 random 15 kb
  pairs at L=16384 for unroll in {1, 8, 32}, in alignments/s (the
  aligner's work per column does not depend on the bases).

Inputs are random, generated from a fixed seed.  Every time is a warm
call's, ended by block_until_ready; compilation is reported apart.
Refuses to run without a GPU.
"""

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _time(fn, reps):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / reps


def main() -> int:
    import jax
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 1
    import jax.numpy as jnp

    import peregrine_tpu  # noqa: F401  (x64)
    from peregrine_tpu.ops.device_align import myers_batch
    from peregrine_tpu.ops.index import index_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    print(f"card: {smi.splitlines()[0]}; jax {jax.__version__}", flush=True)
    rng = np.random.default_rng(0)

    for B, L in ((256, 16384), (8192, 32768)):
        codes = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
        lens = jnp.full((B,), L, jnp.int32)
        rids = jnp.arange(B, dtype=jnp.uint32)
        first, per = _time(lambda: index_step(
            codes, lens, rids, w=80, k=16, r=6, levels=2, cap=L // 8), 5)
        print(f"index_step [{B}, {L}]: first call {first:.2f} s, step "
              f"{per * 1e3:.3f} ms = {B * L / per / 1e6:.1f} padded "
              f"Mbases/s", flush=True)
        del codes

    B, L = 1024, 16384
    q = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
    t = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
    ql = jnp.full((B,), 15000, jnp.int32)
    tl = jnp.full((B,), 15000, jnp.int32)
    for unroll in (1, 8, 32):
        first, per = _time(lambda: myers_batch(q, ql, t, tl, nb=8,
                                               unroll=unroll), 3)
        print(f"myers_batch [{B}, {L}] unroll={unroll}: first call "
              f"{first:.2f} s, batch {per * 1e3:.1f} ms = "
              f"{B / per:.0f} alignments/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
