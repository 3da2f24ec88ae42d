"""chip_smoke.py: refusal without a GPU, and its phase-A comparison helpers
at toy size (on two CPU devices here; on the card under the `gpu` mark)."""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")

_spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu_or_repo(tmp_path, alone):
    script = SCRIPT
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
    r = _run_script(tmp_path, script)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert ("not beside" if alone else "no GPU") in r.stderr


@pytest.fixture(scope="module")
def toy():
    from peregrine_tpu.config import AsmConfig
    from peregrine_tpu.io.seqdb import SeqDB
    genome, reads, truth = cs.simulate(7, genome_bp=100_000)
    # one pad class (16384) keeps the CPU compiles to a minimum
    keep = [i for i, (_, s) in enumerate(reads) if len(s) <= 16384][:64]
    return (SeqDB.from_reads([reads[i] for i in keep]),
            [truth[i] for i in keep], AsmConfig(sketch_batch=8))


def _ref_index(db, cfg, ref):
    import jax
    from peregrine_tpu.ops.index import build_index
    with jax.default_device(ref):
        return build_index(db, cfg)


def _checks(db, truth, cfg, dev, ref):
    return {
        "index_step": lambda: cs.check_index_step(db, 16384, 8, dev, ref,
                                                  reps=1),
        "index_scan": lambda: cs.check_index_scan(db, cfg, dev, ref),
        "myers": lambda: cs.check_myers(
            db, cs.aln_pairs(db, truth, 32, 16384, 7), 16384, dev, ref,
            unroll=1, reps=1),
        "pairs": lambda: cs.check_pairs(_ref_index(db, cfg, ref),
                                        db.lengths, cfg, dev),
        "gather": lambda: cs.check_gather(db, 16384, 16, dev, 7),
    }


@pytest.mark.parametrize("name", ["index_step", "index_scan", "myers",
                                  "pairs", "gather"])
def test_phase_a_helpers_on_cpu(toy, name):
    import jax
    dev, ref = jax.devices("cpu")[:2]
    db, truth, cfg = toy
    assert _checks(db, truth, cfg, dev, ref)[name]() is not None


def test_comparisons_catch_mismatch():
    import jax
    import jax.numpy as jnp
    a = np.arange(10, dtype=np.uint32)
    cs.assert_same((a, a), (a, a.copy()), "same")
    b = a.copy()
    b[3] ^= 1
    with pytest.raises(AssertionError, match="1 of 10 differ"):
        cs.assert_same((a, a), (a, b), "flip")
    with pytest.raises(AssertionError, match="uint32"):
        cs.assert_same(a, a.astype(np.int32), "dtype")
    d0, d1 = jax.devices("cpu")[:2]
    x = jax.device_put(jnp.asarray(a), d0)
    cs.assert_on(x, d0)
    with pytest.raises(AssertionError, match="expected"):
        cs.assert_on(x, d1)
    with pytest.raises(AssertionError, match="cap"):
        cs.require(False, "cap overflow")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["index_step", "index_scan", "myers",
                                  "pairs", "gather"])
def test_phase_a_helpers_on_gpu(gpu, toy, name):
    import jax
    db, truth, cfg = toy
    _checks(db, truth, cfg, gpu, jax.devices("cpu")[0])[name]()
