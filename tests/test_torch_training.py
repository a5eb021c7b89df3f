"""The port's training against the JAX package's, on the CPU.

Reduced configs in f32, weights from ``api.init(jax.random.PRNGKey(seed),
cfg)`` through ``models.convert``, batches from numpy seeds:

  * the flash-attention backward's plain version (the formulas the CUDA
    kernel runs) against ``jax.grad`` of the reference's
    ``ref.attention_ref`` at 2e-5: GQA, MQA, a window, non-causal, rows
    masked by ``kv_pos < 0`` and by ``kv_valid``; ``FlashAttentionFn``
    against autograd of the plain forward;
  * ``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
    reference's on nine reduced archs (bias and tied head, GELU and MQA, MoE
    aux, a window, image embeddings, the SSD scan, a hybrid period, the
    encoder-decoder);
  * ``AdamW.update`` and ``cosine_schedule`` on identical gradients at 1e-6;
  * the replays of ``tests/test_training.py``'s single-device tests and of
    ``tests/test_archs_smoke.py``'s forward and train step for every
    assigned arch;
  * ``token_batches`` draw for draw; the training launcher.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ASSIGNED as JASSIGNED  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.data.synthetic import token_batches as jtoken_batches  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.training import optimizer as joptimizer  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data.synthetic import token_batches  # noqa: E402
from repro_torch.kernels import flash_backward as fbk  # noqa: E402
from repro_torch.kernels import flash_prefill as fk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import convert, encdec, lm, registry  # noqa: E402
from repro_torch.training import train_step  # noqa: E402
from repro_torch.training.optimizer import AdamW, cosine_schedule  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)
# the reference's kernel tolerance (tests/test_kernels.py), f32
BWD_ATOL = 2e-5
# loss_fn's value, f32: the same sums in another order over a reduced model
LOSS_RTOL = 1e-5
# gradients, f32, relative to each leaf's largest magnitude: one backward
# through two layers, a GQA softmax and a 512-way log-sum-exp, whose sums run
# in another order in each framework; the six attention-only archs read at
# most 1.6e-6, mamba2 1.1e-6, whisper 1.3e-6 and jamba 9.6e-6 (its
# in_proj_dt: the scan's d dt sums terms that largely cancel, in f32 in the
# reference)
GRAD_RTOL = 1e-5
ADAM_ATOL = 1e-6
TRAIN_ARCHS = ["llama-7b", "qwen2-0.5b", "granite-34b", "olmoe-1b-7b", "mixtral-8x22b",
               "internvl2-1b", "mamba2-1.3b", "jamba-1.5-large-398b", "whisper-tiny"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------- #
# The backward's plain version
# --------------------------------------------------------------------------- #
BWD_CASES = {
    # name: (H, KV, hd, Sq, Skv, causal, window, masked kv rows, kv_valid)
    "gqa": (4, 2, 16, 12, 12, True, None, False, False),
    "mqa": (4, 1, 16, 12, 12, True, None, False, False),
    "window": (6, 2, 8, 20, 20, True, 5, False, False),
    "non-causal": (4, 2, 16, 9, 14, False, None, False, False),
    "kv-pos-masked": (4, 2, 16, 10, 16, True, None, True, False),
    "kv-valid": (2, 1, 8, 10, 16, False, None, False, True),
}


def _bwd_inputs(case, seed=0):
    H, KV, hd, Sq, Skv, causal, window, masked, valid = BWD_CASES[case]
    rng = np.random.default_rng(seed)
    B = 2
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    dout = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    off = Skv - Sq if causal else 0
    q_pos = np.broadcast_to(np.arange(Sq, dtype=np.int32) + off, (B, Sq)).copy()
    kv_pos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    if masked:  # rows never written, and a query whose every key is masked
        kv_pos[0, 3:7] = -1
        kv_pos[1, :] = np.where(np.arange(Skv) < 9, -1, kv_pos[1])
        q_pos[1, 0] = 2  # sees only the invalid rows 0-2: keeps nothing
    kv_valid = None
    if valid:
        kv_valid = rng.random((B, Skv)) < 0.6
        kv_valid[1, :] = False  # batch 1's queries keep nothing
    kw = dict(causal=causal, window=window)
    return (q, k, v, dout), dict(q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid), kw


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_bwd_plain_matches_jax_grad(case):
    (q, k, v, dout), pos, kw = _bwd_inputs(case)
    jpos = {n: None if a is None else jnp.asarray(a) for n, a in pos.items()}

    def f(q, k, v):
        out = jref.attention_ref(q, k, v, **jpos, **kw)
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tpos = {n: None if a is None else _t(a) for n, a in pos.items()}
    out, lse = fbk.flash_attention_fwd_plain(_t(q), _t(k), _t(v), **tpos, **kw)
    got = fbk.flash_attention_bwd_plain(_t(q), _t(k), _t(v), out, _t(dout), lse, **tpos, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_ATOL, err_msg=name)
    # the forward's output is the plain forward's, bit for bit; a row that
    # keeps no key has lse -inf
    assert torch.equal(out, fk.flash_attention_plain(_t(q), _t(k), _t(v), **tpos, **kw))
    if case in ("kv-pos-masked", "kv-valid"):
        assert torch.isneginf(lse[1, 0]).all()


@pytest.mark.parametrize("case", ["gqa", "window", "kv-pos-masked"])
def test_flash_fn_matches_autograd_of_plain_forward(case):
    (q, k, v, dout), pos, kw = _bwd_inputs(case, seed=1)
    tpos = {n: None if a is None else _t(a) for n, a in pos.items()}
    grads = []
    for fn in (ops.flash_attention, fk.flash_attention_plain):
        qkv = [_t(a).requires_grad_(True) for a in (q, k, v)]
        out = fn(*qkv, **tpos, **kw)
        (out * _t(dout)).sum().backward()
        grads.append((out.detach(), [t.grad for t in qkv]))
    (o1, g1), (o2, g2) = grads
    assert torch.equal(o1, o2)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=BWD_ATOL, rtol=0)


def test_flash_attention_without_grad_takes_the_serving_path():
    (q, k, v, _), pos, kw = _bwd_inputs("gqa")
    tpos = {n: None if a is None else _t(a) for n, a in pos.items()}
    qkv = [_t(a).requires_grad_(True) for a in (q, k, v)]
    with torch.inference_mode():
        out = ops.flash_attention(*[t.detach() for t in qkv], **tpos, **kw)
    assert out.grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(*qkv, **tpos, **kw).grad_fn is None
    grad_fn = ops.flash_attention(*qkv, **tpos, **kw).grad_fn
    assert type(grad_fn).__name__ == "FlashAttentionFnBackward"


# --------------------------------------------------------------------------- #
# loss_fn and its gradients
# --------------------------------------------------------------------------- #
def _setup(arch, seed=0, **over):
    jcfg = jreduced(jget_config(arch), **over)
    cfg = reduced_config(get_config(arch), **over)
    jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    params = convert.from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


def _batch(cfg, B=2, S=24, seed=0):
    """The reference smoke test's batch (``tests/test_archs_smoke.py``)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        dl = min(cfg.decoder_seq_len, 16)
        return {
            "frames": rng.standard_normal((B, 32, cfg.d_model)).astype(np.float32),
            "dec_tokens": rng.integers(0, cfg.vocab, (B, dl)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, dl)).astype(np.int32),
            "mask": np.ones((B, dl), np.float32),
        }
    if cfg.family == "vlm":
        ft = cfg.frontend_tokens
        return {
            "tokens": rng.integers(0, cfg.vocab, (B, S - ft)).astype(np.int32),
            "embeds": (rng.standard_normal((B, ft, cfg.d_model)) * 0.02).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "mask": np.ones((B, S), np.float32),
        }
    mask = np.ones((B, S), np.float32)
    mask[1, S // 2:] = 0.0  # a masked tail
    return {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "mask": mask,
    }


def _assert_grads_close(cfg, grads, jgrads, rtol=GRAD_RTOL):
    got = tree_leaves(convert.to_jax_params(cfg, grads))
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, (cfg.name, i, err, scale)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, jcfg, params, jparams = _setup(arch)
    batch = _batch(cfg)
    (loss, parts), grads = train_step.value_and_grad(params, cfg, batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jparts), jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jparams, jcfg, jbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]), rtol=LOSS_RTOL,
                               atol=1e-7)
    if cfg.moe is not None:
        assert float(parts["aux"]) > 0
    _assert_grads_close(cfg, grads, jgrads)
    # the tied head's two paths and the qkv bias both carry gradient
    if cfg.qkv_bias:
        assert float(grads["layers"][0]["attn"]["bq"].abs().max()) > 0


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_the_same_loss_and_grads(remat):
    cfg, _, params, _ = _setup("qwen2-0.5b")
    batch = _batch(cfg)
    (l0, _), g0 = train_step.value_and_grad(params, cfg, batch)
    rcfg = reduced_config(get_config("qwen2-0.5b"), remat=remat)
    (l1, _), g1 = train_step.value_and_grad(params, rcfg, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# AdamW and the schedule
# --------------------------------------------------------------------------- #
def test_cosine_schedule_matches_reference():
    jfn, fn = joptimizer.cosine_schedule(5, 40), cosine_schedule(5, 40)
    for s in range(0, 45):
        want = float(jfn(jnp.asarray(s, jnp.int32)))
        got = float(fn(torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= ADAM_ATOL, (s, got, want)


@pytest.mark.parametrize("clip,wd", [(1.0, 0.0), (None, 0.01), (0.05, 0.1)])
def test_adamw_update_matches_reference(clip, wd):
    """Three updates on identical numpy gradients: the new parameters,
    moments and step equal the reference's at 1e-6."""
    cfg, jcfg, params, jparams = _setup("qwen2-0.5b", seed=3)
    kw = dict(lr=1e-2, weight_decay=wd, grad_clip=clip)
    jopt = joptimizer.AdamW(schedule=joptimizer.cosine_schedule(1, 5), **kw)
    opt = AdamW(schedule=cosine_schedule(1, 5), **kw)
    jstate, state = jopt.init(jparams), opt.init(params)
    rng = np.random.default_rng(7)
    for _ in range(3):
        jgrads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), jparams)
        grads = convert.from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jgrads),
                                        device="cpu")
        jparams, jstate = jopt.update(jgrads, jstate, jparams)
        params, state = opt.update(grads, state, params)
    assert int(state.step) == int(jstate.step) == 3
    for got, want in ((params, jparams), (state.m, jstate.m), (state.v, jstate.v)):
        for g, w in zip(tree_leaves(convert.to_jax_params(cfg, got)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), atol=ADAM_ATOL, rtol=0)


def test_adamw_keeps_moments_f32_and_params_in_their_dtype():
    cfg = reduced_config(get_config("qwen2-0.5b"), param_dtype="bfloat16", dtype="bfloat16")
    params = lm.init(cfg, seed=0, device="cpu")
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    grads = {**params}
    new, state = opt.update(grads, state, params)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.m) + tree_leaves(state.v))
    assert all(a.dtype == b.dtype for a, b in zip(tree_leaves(new), tree_leaves(params)))


# --------------------------------------------------------------------------- #
# Replays of tests/test_training.py (single device) and the archs' train step
# --------------------------------------------------------------------------- #
def test_loss_decreases_on_learnable_data():
    cfg = reduced_config(get_config("qwen2-0.5b"), n_layers=2, vocab=128)
    params = lm.init(cfg, seed=0, device="cpu")
    opt = AdamW(lr=5e-3, schedule=cosine_schedule(5, 80))
    step = train_step.make_train_step(cfg, opt)
    opt_state = opt.init(params)
    it = token_batches(cfg, batch=8, seq_len=32, seed=0)
    losses = []
    for _ in range(40):
        params, opt_state, m = step(params, opt_state, next(it))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    # clear optimization signal: mean of last 5 well below first 5
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[::10]


def test_grad_accum_matches_full_batch():
    cfg = reduced_config(get_config("llama-7b"), n_layers=2, vocab=64)
    params = lm.init(cfg, seed=0, device="cpu")
    opt = AdamW(lr=1e-3, grad_clip=None)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": rng.integers(0, 64, (8, 16)).astype(np.int32),
        "labels": rng.integers(0, 64, (8, 16)).astype(np.int32),
        "mask": np.ones((8, 16), np.float32),
    }
    p1, _, m1 = train_step.make_train_step(cfg, opt)(params, opt.init(params), batch)
    p2, _, m2 = train_step.make_grad_accum_step(cfg, opt, accum=4)(
        params, opt.init(params), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_train_step_leaves_its_inputs():
    cfg, _, params, _ = _setup("llama-7b")
    before = [t.clone() for t in tree_leaves(params)]
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    train_step.make_train_step(cfg, opt)(params, state, _batch(cfg))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    assert int(state.step) == 0


TRAINABLE = sorted(JASSIGNED)


@pytest.mark.parametrize("arch", TRAINABLE)
def test_smoke_forward_and_train_step(arch):
    """``tests/test_archs_smoke.py``'s forward and train step, for every
    assigned arch."""
    cfg = reduced_config(get_config(arch))
    params = registry.get_model(cfg).init(cfg, seed=0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    if cfg.family == "encdec":
        logits, _ = encdec.forward(params, cfg, batch["frames"], batch["dec_tokens"])
    else:
        logits, _ = lm.forward(params, cfg, batch["tokens"], embeds=batch.get("embeds"))
    assert logits.shape == tuple(batch["labels"].shape) + (cfg.padded_vocab,)
    assert bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits"
    opt = AdamW(lr=1e-3)
    params2, _, metrics = train_step.make_train_step(cfg, opt)(params, opt.init(params), batch)
    assert bool(torch.isfinite(metrics["loss"])), f"{arch}: non-finite loss"
    assert int(metrics["step"]) == 1
    moved = any(float((a.float() - b.float()).abs().max()) > 0
                for a, b in zip(tree_leaves(params), tree_leaves(params2)))
    assert moved, f"{arch}: train step did not update params"


# --------------------------------------------------------------------------- #
# Data and the launcher
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 3])
def test_token_batches_match_reference(seed):
    cfg, jcfg = reduced_config(get_config("qwen2-0.5b")), jreduced(jget_config("qwen2-0.5b"))
    it, jit_ = token_batches(cfg, batch=4, seq_len=16, seed=seed), jtoken_batches(
        jcfg, batch=4, seq_len=16, seed=seed)
    for _ in range(3):
        got, want = next(it), next(jit_)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_train_launcher_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--reduced", "--steps", "6", "--batch", "4", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    out = train_cli.main(argv)
    assert out["completed"] == 6 and np.isfinite(out["metrics"]["loss"])
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000003",
                                                               "step_00000006"]
    line = capsys.readouterr().out
    assert line.startswith("qwen2-0.5b-smoke: step 6 loss "), line
    again = train_cli.main(argv + ["--steps", "8"])  # resumes from step 6
    assert again["completed"] == 8 and int(again["opt_state"].step) == 8
