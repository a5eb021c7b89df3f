"""The port's VLM family (internvl2-1b) against the JAX package's, on the CPU.

A request to ``internvl2-1b`` may carry precomputed image embeddings
(``Request.embeds``, ``[1, frontend_tokens, d_model]``): the LM puts them
before the prompt's token embeddings, and the image's positions are the
reusable context.  Reduced internvl (8 image positions, d_model 64, QKV
bias, tied embeddings, f32) runs on weights converted from the reference's:

  * ``lm.prefill`` with ``embeds`` (and a decode after it), and the load
    path (the stored image rows inserted, the prompt prefilled after them)
    at logits atol 5e-5;
  * ``tests/test_serving.py::test_vlm_image_context_reuse`` replayed on
    both engines under dense decode, ``paged_decode=True`` and
    ``unified_step=True``: records, summaries and events at 1e-9, tokens
    exact, and reuse generating recompute's tokens;
  * text-only requests to the same arch still pack, an image request
    behind them waiting a step, on both engines alike.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import blocks, lm, registry  # noqa: E402
from test_torch_engine import _replay_on_both, _requests, _run_port, _setup  # noqa: E402
from test_torch_models import _port_artifact  # noqa: E402

torch.set_num_threads(1)
ARCH = "internvl2-1b"
ATOL = 5e-5
MAX_LEN = 128
MODES = {"dense": {}, "paged": dict(paged_decode=True),
         "unified": dict(paged_decode=True, unified_step=True)}


@pytest.fixture(scope="module")
def vlm():
    return _setup(ARCH)


def _image(cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(
        np.float32)


def test_vlm_is_a_dense_stack_that_packs(vlm):
    """The VLM family is the dense block stack: packable, partial reuse
    allowed by the arch (the engine refuses it to an embeds request)."""
    cfg = vlm[2]
    assert cfg.family == "vlm" and cfg.frontend_tokens == 8
    assert [tuple(k) for k in blocks.block_kinds(cfg)] == [("a", "mlp")]
    assert paged.packable_arch(cfg, MAX_LEN) and paged.partial_reuse_allowed(cfg)
    assert registry.get_model(cfg).prefill_packed is lm.prefill_packed


def test_prefill_with_embeds_matches_reference(vlm):
    """The image's embeddings then a 6-token prompt in one prefill, two
    decode steps after it, and the load path: the stored image rows in a
    fresh slot, the prompt prefilled after them.  Logits at 5e-5 with the
    reference's argmax; the load's logits are the full path's."""
    jcfg, jparams, cfg, params = vlm
    image = _image(cfg, 1)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab, (1, 6)).astype(np.int32)
    jl, jst = jlm.prefill(jparams, jcfg, jnp.asarray(prompt), jlm.init_state(jcfg, 1, MAX_LEN),
                          embeds=jnp.asarray(image))
    tl, tst = lm.prefill(params, cfg, torch.from_numpy(prompt),
                         lm.init_state(cfg, 1, MAX_LEN, device="cpu"), embeds=image)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tst.pos.tolist() == np.asarray(jst.pos).tolist() == [8 + 6]
    jd, td = jl, tl
    js, ts = jst, tst
    for _ in range(2):
        toks = np.asarray(jd).argmax(-1)[:, None].astype(np.int32)
        assert td.argmax(-1).tolist() == toks[:, 0].tolist()
        jd, js = jlm.decode(jparams, jcfg, jnp.asarray(toks), js)
        td, ts = lm.decode(params, cfg, torch.from_numpy(toks), ts)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)

    # the load path: the image's 8 stored rows, then the prompt alone
    jart = jpaged.extract_slot(jcfg, jst, 0, cfg.frontend_tokens)
    art = paged.extract_slot(cfg, tst, 0, cfg.frontend_tokens)
    np.testing.assert_allclose(art.caches[0].attn.k, np.asarray(jart.caches[0].attn.k),
                               atol=ATOL)
    ts1 = paged.insert_slot(cfg, lm.init_state(cfg, 1, MAX_LEN, device="cpu"), 0,
                            _port_artifact(jart))
    tl1, _ = lm.prefill(params, cfg, torch.from_numpy(prompt), ts1)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl), atol=ATOL)
    # a tensor of embeds, and embeds alone (no tokens), as the reference takes them
    jl2, _ = jlm.prefill(jparams, jcfg, None, jlm.init_state(jcfg, 1, MAX_LEN),
                         embeds=jnp.asarray(image))
    tl2, _ = lm.prefill(params, cfg, None, lm.init_state(cfg, 1, MAX_LEN, device="cpu"),
                        embeds=torch.from_numpy(image))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)


def _image_requests(cfg, seed=6, n=3):
    """``tests/test_serving.py:162``'s mix, from its seed: ``n`` requests
    over one image, its 8-token identity proxy as the context."""
    rng = np.random.default_rng(seed)
    ft = cfg.frontend_tokens
    embeds = (rng.standard_normal((1, ft, cfg.d_model)) * 0.02).astype(np.float32)
    ctx_proxy = list(map(int, rng.integers(0, 1000, ft)))
    return [
        dict(req_id=i, context_tokens=ctx_proxy,
             prompt_tokens=list(map(int, rng.integers(0, cfg.vocab, 8))),
             max_new_tokens=3, arrival_s=i * 0.01, expected_reuses=3, embeds=embeds)
        for i in range(n)
    ]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_vlm_image_context_reuse(vlm, mode):
    """``tests/test_serving.py:162`` on both engines: the stored image rows
    are loaded twice (the chunk no longer than the 8-token proxy) and
    generate recompute's tokens; every admission runs through
    ``ModelApi.prefill``, never packed."""
    reqs = _image_requests(vlm[2])
    eng, events = _replay_on_both(vlm, reqs, "always", chunk_tokens=8, **MODES[mode])
    off, _ = _run_port(*vlm[2:], reqs, chunk_tokens=8, reuse_enabled=False, **MODES[mode])
    assert [r.action for r in sorted(eng.records, key=lambda r: r.req_id)] == [
        "recompute", "load", "load"]
    assert {r.req_id: r.tokens for r in eng.records} == {
        r.req_id: r.tokens for r in off.records}
    assert eng.batches == 0 and eng.unified_stats()["steps"] == 0
    assert eng.decode_stats()["paged"] is bool(MODES[mode])
    loads = [e for e in events if type(e).__name__ == "KVLoaded"]
    assert [e.matched_tokens for e in loads] == [8, 8]
    if MODES[mode]:
        eng._paged.audit()
        assert eng._paged.pool.n_used == 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_text_requests_pack_beside_image_requests(vlm, mode):
    """Text-only requests to the VLM take the packed (or chunked) path; an
    image request behind them in the queue waits a step and is admitted
    alone.  The serve replays the reference's."""
    cfg = vlm[2]
    text = _requests(cfg.vocab, n=4, ctx_len=32)
    image = _image_requests(cfg, n=2)
    for i, r in enumerate(image):
        r.update(req_id=10 + i, arrival_s=0.001 + 0.02 * i)
    eng, events = _replay_on_both(vlm, text[:2] + image + text[2:], "always", chunk_tokens=8,
                                  **MODES[mode])
    assert eng.batches >= 1 or eng.unified_stats()["steps"] >= 1
    acts = {r.req_id: r.action for r in eng.records}
    assert acts[10] == "recompute" and acts[11] == "load"
    batches = [e for e in events if type(e).__name__ == "BatchAdmitted"]
    assert all(10 not in e.req_ids and 11 not in e.req_ids for e in batches)
