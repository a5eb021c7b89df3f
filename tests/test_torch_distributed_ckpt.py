"""Checkpoints of the port's data-parallel training across data sizes and
packages, on the CPU (the replay of
``tests/test_checkpoint.py::test_elastic_reshape_restore``): a checkpoint
saved at one rank resumes at two gloo ranks (``torch_dist_ranks.spawn``)
with the ZeRO-1 moments re-sliced; one saved at two restores at one rank
and through the JAX package's ``restore``; a preempted two-rank
``ResilientLoop`` resumes bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as joptimizer  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import host_mesh  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.training.fault import LoopConfig, ResilientLoop, adam_to_jax  # noqa: E402
from repro_torch.training.optimizer import AdamW, opt_specs  # noqa: E402
from repro_torch.training.train_step import make_sharded_train_step  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402
from test_torch_distributed_train import ADAMW, _batch, _FakeMesh, _reference_params  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402

torch.set_num_threads(1)


def _one_rank_loop(cfg, params, batches, path, total):
    with host_mesh(1, 1, device="cpu") as mesh:
        step = make_sharded_train_step(cfg, AdamW(**ADAMW), mesh)
        loop = ResilientLoop(step, lambda i: batches[i],
                             LoopConfig(total_steps=total, ckpt_every=2, ckpt_dir=str(path)),
                             model_cfg=cfg)
        return loop.run(params, step.init(params))


def test_elastic_reshape_restore(tmp_path):
    arch = "qwen2-0.5b"
    cfg = reduced_config(get_config(arch))
    jcfg, jparams = _reference_params(arch)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    batches_np = [_batch(cfg, seed=s) for s in range(4)]
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches_np]
    params0 = convert.from_jax_params(cfg, params_np, device="cpu")

    # saved at one rank (step 2) ...
    first = _one_rank_loop(cfg, params0, batches, tmp_path / "elastic", 2)
    inputs = dict(arch=arch, params={arch: params_np}, batches={arch: batches_np}, adamw=ADAMW,
                  dir=str(tmp_path), resume_at=2)
    outs = spawn("checkpoint", 2, tmp_path / "ranks", inputs)
    # ... resumed at two ranks: each holds its slice of the saved moments
    mesh = _FakeMesh(data=2)
    specs = opt_specs(sh.param_specs(cfg, params0, mesh), params0, mesh).m
    sliced = 0
    for r, out in enumerate(outs):
        for spec, whole, local in zip(tree_leaves(specs), tree_leaves(first["opt_state"].m),
                                      tree_leaves(out["restored_m"])):
            if "data" in spec:
                dim = list(spec).index("data")
                rows = whole.shape[dim] // 2
                whole = whole.narrow(dim, r * rows, rows)
                sliced += 1
            np.testing.assert_array_equal(local, whole.numpy())
    assert sliced > 0
    # saved at two ranks (step 4): restored at one rank ...
    after = outs[0]["after"]
    back = _one_rank_loop(cfg, params0, batches, tmp_path / "elastic", 4)
    assert int(back["opt_state"].step) == 4
    for got, want in zip(tree_leaves((convert.to_jax_params(cfg, back["params"]),
                                      adam_to_jax(cfg, back["opt_state"]))),
                         tree_leaves((after["params"], after["opt"]))):
        np.testing.assert_array_equal(got, want)
    # ... and by the reference's restore into its own tree
    jopt = joptimizer.AdamW(**ADAMW)
    restored, step = jckpt.restore(tmp_path / "elastic", (jparams, jopt.init(jparams)))
    assert step == 4
    for got, want in zip(jax.tree_util.tree_leaves(restored),
                         tree_leaves((after["params"], after["opt"]))):
        np.testing.assert_array_equal(np.asarray(got), want)
    # a preempted two-rank loop resumes bit for bit
    for out in outs:
        assert out["preempted"] and out["resume_equal"] and all(out["resume_equal"])
