"""The port's checkpoints and resilient loop, on the CPU.

Replays the single-device tests of ``tests/test_checkpoint.py`` on the
port (atomic round trip, retention, an incomplete checkpoint ignored, a
shape mismatch rejected, preemption with a bit-exact resume, in the port's
layout and in the reference's), then holds the on-disk format to the
reference's: a checkpoint either package writes restores in the other, at
f32 and with bf16 leaves (which the port writes as f32 and reads from the
reference's raw 2-byte records).  The elastic-reshape restore waits for
distribution (queue item A11).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as joptimizer  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data.synthetic import token_batches  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.training import checkpoint as ckpt, fault  # noqa: E402
from repro_torch.training.fault import LoopConfig, Preempted, ResilientLoop  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402
from repro_torch.training.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)
SMALL = dict(n_layers=2, vocab=64)


def _tiny():
    cfg = reduced_config(get_config("qwen2-0.5b"), **SMALL)
    params = lm.init(cfg, seed=0, device="cpu")
    opt = AdamW(lr=1e-3)
    return cfg, params, opt


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(ckpt.to_numpy(x), ckpt.to_numpy(y))


# --------------------------------------------------------------------------- #
# Replays of tests/test_checkpoint.py
# --------------------------------------------------------------------------- #
def test_roundtrip_and_latest(tmp_path):
    _, params, opt = _tiny()
    tree = (params, opt.init(params))
    ckpt.save(tmp_path, 7, tree)
    ckpt.save(tmp_path, 13, tree)
    assert ckpt.latest_step(tmp_path) == 13
    restored, step = ckpt.restore(tmp_path, tree)
    assert step == 13
    _assert_trees_equal(tree, restored)
    assert type(restored[1]).__name__ == "AdamState"


def test_retention_gc(tmp_path):
    _, params, opt = _tiny()
    for s in range(6):
        ckpt.save(tmp_path, s, params, keep=2)
    steps = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert len(steps) == 2 and steps[-1] == "step_00000005"


def test_incomplete_checkpoint_ignored(tmp_path):
    _, params, opt = _tiny()
    ckpt.save(tmp_path, 3, params)
    # simulate a crash mid-write at a later step: directory without manifest
    (tmp_path / "step_00000009").mkdir()
    assert ckpt.latest_step(tmp_path) == 3
    _, step = ckpt.restore(tmp_path, params)
    assert step == 3


def test_shape_mismatch_rejected(tmp_path):
    _, params, opt = _tiny()
    ckpt.save(tmp_path, 1, params)
    bad = tree_map(lambda x: np.zeros(tuple(x.shape) + (2,), np.float32), params)
    with pytest.raises(ValueError, match="leaf"):
        ckpt.restore(tmp_path, bad)


@pytest.mark.parametrize("layout", ["port", "reference"])
def test_preemption_resume_bit_exact(tmp_path, layout):
    """Kill training mid-run; re-invoking the loop restores and the final
    params are IDENTICAL to an uninterrupted run (same data order), with the
    checkpoints in the port's tree or in the reference's layout."""
    cfg, params0, opt = _tiny()
    step_fn = make_train_step(cfg, opt)
    batches = [
        {k: torch.as_tensor(v) for k, v in b.items()}
        for _, b in zip(range(12), token_batches(cfg, batch=4, seq_len=16, seed=1))
    ]
    batch_fn = lambda i: batches[i]  # noqa: E731
    model_cfg = cfg if layout == "reference" else None

    def loop(path, **kw):
        return ResilientLoop(step_fn, batch_fn,
                             LoopConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(path)),
                             model_cfg=model_cfg, **kw)

    # uninterrupted reference
    ref = loop(tmp_path / "ref").run(params0, opt.init(params0))

    # preempted run: dies at step 6 (after the step-4 checkpoint)
    pre_dir = tmp_path / "pre"

    def bomb(step):
        if step == 6:  # after the async step-4 checkpoint was initiated
            raise Preempted("simulated preemption")

    loop1 = loop(pre_dir, failure_hook=bomb)
    with pytest.raises(Preempted):
        loop1.run(params0, opt.init(params0))
    loop1.ckpt.wait()
    assert ckpt.latest_step(pre_dir) == 4

    # plain re-invocation resumes from step 4 and finishes
    out = loop(pre_dir).run(params0, opt.init(params0))
    for a, b in zip(tree_leaves(ref["params"]), tree_leaves(out["params"])):
        assert torch.equal(a, b)
    _assert_trees_equal(ref["opt_state"], out["opt_state"])


# --------------------------------------------------------------------------- #
# The format across packages
# --------------------------------------------------------------------------- #
def _both(dtype="float32", seed=0):
    over = dict(SMALL, param_dtype=dtype, dtype=dtype)
    jcfg = jreduced(jget_config("qwen2-0.5b"), **over)
    cfg = reduced_config(get_config("qwen2-0.5b"), **over)
    jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    params = convert.from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


def _stepped_states(cfg, jcfg, params, jparams):
    """Both packages' (params, AdamState) after one step on the same batch."""
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 64, (2, 12)).astype(np.int32),
             "labels": rng.integers(0, 64, (2, 12)).astype(np.int32)}
    opt, jopt = AdamW(lr=1e-2), joptimizer.AdamW(lr=1e-2)
    p, s, _ = make_train_step(cfg, opt)(params, opt.init(params), batch)
    jp, js, _ = jtrain.make_train_step(jcfg, jopt)(
        jparams, jopt.init(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    return (p, s), (jp, js)


def test_port_checkpoint_restores_in_reference(tmp_path):
    cfg, jcfg, params, jparams = _both()
    (p, s), (jp, js) = _stepped_states(cfg, jcfg, params, jparams)
    on_disk = (convert.to_jax_params(cfg, p), fault.adam_to_jax(cfg, s))
    ckpt.save(tmp_path, 1, on_disk)
    restored, step = jckpt.restore(tmp_path, (jp, js))
    assert step == 1
    got = jax.tree_util.tree_leaves(restored)
    assert len(got) == len(jax.tree_util.tree_leaves((jp, js)))
    for a, b in zip(got, tree_leaves(on_disk)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(restored[1].step) == 1


def test_reference_checkpoint_restores_in_port(tmp_path):
    cfg, jcfg, params, jparams = _both()
    (p, s), (jp, js) = _stepped_states(cfg, jcfg, params, jparams)
    jckpt.save(tmp_path, 1, (jp, js))
    like = (convert.to_jax_params(cfg, p), fault.adam_to_jax(cfg, s))
    (rp, rs), step = ckpt.restore(tmp_path, like)
    assert step == 1
    for a, b in zip(tree_leaves((rp, rs)), jax.tree_util.tree_leaves((jp, js))):
        np.testing.assert_array_equal(a, np.asarray(b))
    # back into the port's own trees
    params_back = convert.from_jax_params(cfg, rp, device="cpu")
    state_back = fault.adam_from_jax(cfg, rs, device="cpu")
    assert int(state_back.step) == 1
    _assert_trees_equal(convert.to_jax_params(cfg, params_back), rp)
    _assert_trees_equal(convert.to_jax_params(cfg, state_back.m), rs.m)


def test_reference_loop_checkpoint_resumes_port_loop(tmp_path):
    """The reference's ``ResilientLoop`` stops at step 4; the port's loop,
    in the reference's layout, resumes there and finishes: its step count
    and moments come from the reference's checkpoint."""
    from repro.training.fault import LoopConfig as JLoopConfig
    from repro.training.fault import ResilientLoop as JResilientLoop

    cfg, jcfg, params, jparams = _both()
    batches = list(zip(range(6), token_batches(cfg, batch=2, seq_len=12, seed=2)))
    jopt, opt = joptimizer.AdamW(lr=1e-2), AdamW(lr=1e-2)
    JResilientLoop(jax.jit(jtrain.make_train_step(jcfg, jopt)),
                   lambda i: {k: jnp.asarray(v) for k, v in batches[i][1].items()},
                   JLoopConfig(total_steps=4, ckpt_every=4, ckpt_dir=str(tmp_path))).run(
        jparams, jopt.init(jparams))
    assert ckpt.latest_step(tmp_path) == 4
    out = ResilientLoop(make_train_step(cfg, opt), lambda i: batches[i][1],
                        LoopConfig(total_steps=6, ckpt_every=2, ckpt_dir=str(tmp_path)),
                        model_cfg=cfg).run(params, opt.init(params))
    assert int(out["opt_state"].step) == 6 and ckpt.latest_step(tmp_path) == 6
    assert np.isfinite(out["metrics"]["loss"])


def test_bf16_round_trips(tmp_path):
    """bf16 leaves: the port writes them as f32 (exact), which both
    packages read back to the same bf16 bits; the reference's own bf16
    records (raw 2-byte ``V2`` in the npz) read into the port bit for bit."""
    cfg, jcfg, params, jparams = _both("bfloat16")
    assert params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    # port -> port
    ckpt.save(tmp_path / "port", 1, params)
    manifest = (tmp_path / "port" / "step_00000001" / "manifest.json").read_text()
    assert "bfloat16" not in manifest and "float32" in manifest
    back, _ = ckpt.restore(tmp_path / "port", params)
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # port -> reference
    ckpt.save(tmp_path / "p2r", 1, convert.to_jax_params(cfg, params))
    jback, _ = jckpt.restore(tmp_path / "p2r", jparams)
    for a, b in zip(jax.tree_util.tree_leaves(jback), tree_leaves(convert.to_jax_params(
            cfg, params))):
        assert str(np.asarray(a).dtype) == "bfloat16"
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32), b)
    # reference -> port
    jckpt.save(tmp_path / "r2p", 1, jparams)
    assert "bfloat16" in (tmp_path / "r2p" / "step_00000001" / "manifest.json").read_text()
    got, _ = ckpt.restore(tmp_path / "r2p", convert.to_jax_params(cfg, params))
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b).astype(np.float32))
    port_params = convert.from_jax_params(cfg, got, device="cpu")
    for a, b in zip(tree_leaves(port_params), tree_leaves(params)):
        assert torch.equal(a, b)
