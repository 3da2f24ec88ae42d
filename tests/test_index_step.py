"""The fused index step on every backend is the one XLA program.

index_step (sketch -> L1 -> L2) at the batch shapes the pipeline feeds
it, against the transliterated reference oracles; the log-shift stream
compaction against a stable sort; and a check that no platform branch is
left in the path (the same function traced as if on a GPU gives the same
records).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from peregrine_tpu.io.seqdb import seq_to_codes
from peregrine_tpu.ops import device_align, index, reduce, sketch
from peregrine_tpu.ops.index import index_step
from tests import oracles
from tests.conftest import random_seq

WKR = [(80, 16, 6), (24, 12, 4), (12, 8, 3)]


def _batch(rng, B: int, L: int):
    lens = rng.integers(L // 3, L + 1, B)
    lens[0] = L
    seqs = [random_seq(rng, int(n)) for n in lens]
    codes = np.full((B, L), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = seq_to_codes(s)
    return seqs, codes, lens.astype(np.int32)


def _oracle_l2(seqs, w, k, r):
    out = []
    for rid, s in enumerate(seqs):
        l0 = oracles.mm_sketch(s, w, k, rid)
        out.append(oracles.mm_reduce(oracles.mm_reduce(l0, r), r))
    return out


@pytest.mark.parametrize("B,L", [(8, 4096), (16, 8192)])
@pytest.mark.parametrize("w,k,r", WKR)
def test_index_step_matches_oracle(rng, B, L, w, k, r):
    seqs, codes, lens = _batch(rng, B, L)
    # the pipeline's drain cap where the minimizer density fits it
    cap = L // 8 if 2 / (w + 1) < 1 / 8 else 0
    x, y, c, c0 = jax.device_get(index_step(
        jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(np.arange(B, dtype=np.uint32)),
        w=w, k=k, r=r, levels=2, cap=cap))
    if cap:
        assert (c0 <= cap).all() and (c <= x.shape[1]).all()
    want = _oracle_l2(seqs, w, k, r)
    for b in range(B):
        got = list(zip(x[b, :c[b]].tolist(), y[b, :c[b]].tolist()))
        assert got == want[b], f"read {b}"


@jax.jit
def _both_compactions(keep, vals, aux):
    return (sketch._sort_compact(keep, [vals, aux]),
            sketch._shift_compact(keep, [vals, aux],
                                  fills=[sketch.INF, 0xFFFFFFFF]))


@settings(max_examples=30, deadline=None)
@given(B=st.sampled_from([1, 3, 8]), L=st.sampled_from([64, 100, 128, 257]),
       p=st.floats(0.0, 1.0), seed=st.integers(0, 2**32 - 1))
def test_shift_compact_equals_sort_compact(B, L, p, seed):
    """Over row-aligned (multiples of 8 x 128) and unaligned shapes."""
    r = np.random.default_rng(seed)
    keep = r.random((B, L)) < p
    vals = np.where(keep, r.integers(0, 2**63, (B, L)).astype(np.uint64),
                    np.uint64(0xFFFFFFFFFFFFFFFF))
    aux = np.where(keep, r.integers(0, 2**32, (B, L)), 0xFFFFFFFF
                   ).astype(np.uint32)
    (want, wn), (got, gn) = _both_compactions(
        jnp.asarray(keep), jnp.asarray(vals), jnp.asarray(aux))
    np.testing.assert_array_equal(np.asarray(wn), np.asarray(gn))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_index_step_has_no_platform_branch(rng, monkeypatch):
    """Traced as if the default backend were a GPU, index_step runs the
    same program: no module on the path asks for the platform."""
    for mod in (index, sketch, reduce):
        assert "default_backend" not in inspect.getsource(mod)
    B, L = 8, 4096
    _, codes, lens = _batch(rng, B, L)
    args = (jnp.asarray(codes), jnp.asarray(lens),
            jnp.asarray(np.arange(B, dtype=np.uint32)))
    kw = dict(w=80, k=16, r=6, levels=2, cap=L // 8)
    want = jax.device_get(index_step(*args, **kw))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    # a fresh jit of the same function traces anew under the patched backend
    fresh = jax.jit(index_step.__wrapped__,
                    static_argnames=("w", "k", "r", "levels", "cap"))
    got = jax.device_get(fresh(*args, **kw))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend,want", [("cpu", 1),
                                          ("gpu", device_align.ACCEL_UNROLL)])
def test_aligner_unroll_follows_backend(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device_align.default_unroll() == want
