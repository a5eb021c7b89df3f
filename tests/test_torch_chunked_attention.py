"""The plain path's q-chunked attention (the reference's
``ref.attention_ref_chunked`` behind ``ops.py``'s ``CHUNKED_THRESHOLD``).

``ref.attention_ref_chunked`` against ``ref.attention_ref`` and the
reference's ``attention_ref_chunked`` on the same inputs at atol 2e-5, for
causal, windowed, non-causal and ``kv_valid`` inputs and a last chunk
shorter than the others; the plain forward with its ``lse`` and the plain
backward of row 10 (``flash_backward``) chunked against themselves
unchunked; and the threshold's choice (``ref.q_chunks``) at the
reference's shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_backward as fbk  # noqa: E402
from repro_torch.kernels import flash_prefill as fk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(1)
ATOL = 2e-5
CASES = {
    "causal": dict(causal=True, window=None, valid=False),
    "window": dict(causal=True, window=9, valid=False),
    "non-causal": dict(causal=False, window=None, valid=False),
    "kv_valid": dict(causal=True, window=None, valid=True),
}


def _inputs(seed, B=2, Sq=37, Skv=48, H=4, KV=2, hd=16, valid=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kv_pos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    kv_pos[1, -3:] = -1
    kv_valid = (rng.random((B, Skv)) < 0.8) if valid else None
    return q, k, v, q_pos, kv_pos, kv_valid


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("q_chunk", [8, 16])
def test_chunked_matches_unchunked_and_reference(name, q_chunk):
    case = CASES[name]
    q, k, v, q_pos, kv_pos, kv_valid = _inputs(1, valid=case["valid"])
    kw = dict(causal=case["causal"], window=case["window"])
    tq, tk, tv, tqp, tkp, tvalid = _t(q, k, v, q_pos, kv_pos, kv_valid)
    got = ref.attention_ref_chunked(tq, tk, tv, q_pos=tqp, kv_pos=tkp, kv_valid=tvalid,
                                    q_chunk=q_chunk, **kw)
    whole = ref.attention_ref(tq, tk, tv, q_pos=tqp, kv_pos=tkp, kv_valid=tvalid, **kw)
    want = jref.attention_ref_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(q_pos),
        kv_pos=jnp.asarray(kv_pos), kv_valid=None if kv_valid is None else jnp.asarray(kv_valid),
        q_chunk=q_chunk, **kw)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_threshold_is_the_reference_s():
    """One slice below 2048 x 8192, 512-query slices at or above it (the
    last shorter), as the reference's ``ops.flash_attention`` routes."""
    assert ref.CHUNKED_THRESHOLD == jops.CHUNKED_THRESHOLD == 2048 * 8192
    assert ref.q_chunks(2047, 8192) == [slice(0, 2047)]
    assert ref.q_chunks(4096, 4096) == [slice(i, i + 512) for i in range(0, 4096, 512)]
    assert ref.q_chunks(32768, 32768)[-1] == slice(32256, 32768)
    assert ref.q_chunks(2100, 8192)[-1] == slice(2048, 2100)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_paths_chunk_above_the_threshold(monkeypatch, name):
    """With the threshold lowered under the inputs' ``Sq x Skv`` the plain
    flash forward, its ``lse`` and the plain backward run in slices of
    ``Q_CHUNK`` queries (lowered to 8 here) and give the unchunked
    values: the forward at 2e-5, ``lse`` and dq exactly per row, dk and dv
    (summed over the slices in f32) at 2e-5."""
    case = CASES[name]
    q, k, v, q_pos, kv_pos, kv_valid = _inputs(2, valid=case["valid"])
    tq, tk, tv, tqp, tkp, tvalid = _t(q, k, v, q_pos, kv_pos, kv_valid)
    dout = torch.from_numpy(np.random.default_rng(3).standard_normal(q.shape).astype(np.float32))
    kw = dict(q_pos=tqp, kv_pos=tkp, kv_valid=tvalid, causal=case["causal"],
              window=case["window"])

    def run():
        out = fk.flash_attention_plain(tq, tk, tv, **kw)
        o2, lse = fbk.flash_attention_fwd_plain(tq, tk, tv, **kw)
        grads = fbk.flash_attention_bwd_plain(tq, tk, tv, o2, dout, lse, **kw)
        return out, o2, lse, grads

    whole = run()
    monkeypatch.setattr(ref, "CHUNKED_THRESHOLD", 8)
    monkeypatch.setattr(ref, "Q_CHUNK", 8)
    assert len(ref.q_chunks(q.shape[1], k.shape[1])) == 5
    chunked = run()
    np.testing.assert_allclose(chunked[0].numpy(), whole[0].numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(chunked[1].numpy(), whole[1].numpy(), atol=ATOL, rtol=0)
    torch.testing.assert_close(chunked[2], whole[2], rtol=0, atol=0)
    torch.testing.assert_close(chunked[3][0], whole[3][0], rtol=0, atol=0)
    for g, w in zip(chunked[3][1:], whole[3][1:]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=0)
