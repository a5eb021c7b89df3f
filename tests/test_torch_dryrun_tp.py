"""The dry run's tensor-parallel and pod-axis train records against the
real steps: four gloo ranks (``torch_dist_ranks`` case ``dryrun_tp``) run
reduced qwen2-0.5b's ``make_sharded_train_step`` on (data 2, model 2) and
on (pod 2, data 2, model 1), wrapping ``dist.all_reduce`` and
``dist.all_gather``; the record ``run_cell`` writes for the same cell on a
fake group of that mesh must hold:

  * its by-op collective bytes, ``model_tensor_parallel`` and
    ``pod_gradient_sync`` equal to the bytes the ranks' calls issue, in
    total, by op and on the model and pod groups;
  * ``flops`` equal to rank 0's ``FlopCounterMode`` count of its real step,
    and on the layout-(a) mesh to ``step_flops / model`` (relative 1e-9);
  * on (data 2, model 2), ``temp_bytes`` below the same cell's on (data
    2, model 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402

torch.set_num_threads(1)
ARCH = "qwen2-0.5b"
TRAIN = ShapeSpec("train_small", "train", 16, 4)
MESHES = {(2, 2): ("data", "model"), (2, 2, 1): ("pod", "data", "model")}


def _record(dims):
    cfg = reduced_config(get_config(ARCH))
    rec = dryrun.run_cell(ARCH, TRAIN.name, False, None, cfg=cfg, shape=TRAIN,
                          mesh_shape=(dims, MESHES.get(dims, ("data", "model"))))
    assert rec["ok"], rec.get("traceback")
    return rec


@pytest.fixture(scope="module")
def real_steps(tmp_path_factory):
    rng = np.random.default_rng(0)
    vocab = reduced_config(get_config(ARCH)).vocab
    shape = (TRAIN.global_batch, TRAIN.seq_len)
    tokens = rng.integers(0, vocab, shape).astype(np.int32)
    batch = dict(tokens=tokens, labels=np.roll(tokens, -1, axis=1),
                 mask=(rng.random(shape) < 0.8).astype(np.float32))
    inputs = dict(arch=ARCH, batch=batch, meshes=list(MESHES))
    return spawn("dryrun_tp", 4, tmp_path_factory.mktemp("dryrun_tp"), inputs)


@pytest.mark.parametrize("dims", list(MESHES), ids=["data2xmodel2", "pod2xdata2xmodel1"])
def test_collectives_equal_the_real_steps(real_steps, dims):
    rec = _record(dims)
    coll = rec["collectives"]
    by_op = {k: v for k, v in coll.items()
             if k not in ("total", "model_tensor_parallel", "pod_gradient_sync")}
    want = {"model_tensor_parallel": "model", "pod_gradient_sync": "pod"}
    for out in real_steps:
        got = out[dims]
        assert got["by_op"] == by_op
        for key, axis in want.items():
            if key in coll:
                assert coll[key] == got["by_group"][axis] > 0, key
            else:
                assert axis not in got["by_group"]
    assert coll["total"] == sum(by_op.values())
    assert ("model_tensor_parallel" in coll) is (dims[-1] > 1)
    assert ("pod_gradient_sync" in coll) is (len(dims) == 3)
    assert rec["not_run"] == {}


@pytest.mark.parametrize("dims", list(MESHES), ids=["data2xmodel2", "pod2xdata2xmodel1"])
def test_flops_are_the_model_ranks_own(real_steps, dims):
    rec = _record(dims)
    assert rec["flops"] == real_steps[0][dims]["flops"] > 0
    model = dims[-1]
    assert rec["flops"] == pytest.approx(rec["step_flops"] / model, rel=1e-9, abs=0)


def test_temp_bytes_fall_below_model_one():
    """The model axis splits the activations (the f32 logits over the
    vocab among them)."""
    rec, whole = _record((2, 2)), _record((2, 1))
    assert 0 < rec["memory"]["temp_bytes"] < whole["memory"]["temp_bytes"]
    assert "model_tensor_parallel" not in whole["collectives"]


def test_step_counter_tells_groups_apart_by_schema():
    """``StepCounter.by_group`` files a c10d op under its ``ProcessGroup``
    and a functional collective under its ``group_name`` argument, not its
    reduce op's string: a functional all-reduce and reduce-scatter on the
    model and data groups of a fake (data 2, model 2) mesh."""
    import torch.distributed as dist

    fn = torch.ops._c10d_functional
    t = torch.ones(4, 8)
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        model, data = mesh.get_group("model"), mesh.get_group("data")
        counter = dryrun.StepCounter({model.group_name: "model", data.group_name: "data"})
        with counter:
            dist.all_reduce(t.clone(), group=model)
            fn.wait_tensor(fn.all_reduce(t, "sum", model.group_name))
            fn.wait_tensor(fn.reduce_scatter_tensor(t, "sum", 2, data.group_name))
            fn.wait_tensor(fn.all_gather_into_tensor(t, 2, data.group_name))
    assert counter.by_group == {"model": 2 * 128, "data": 64 + 256}, counter.by_group
    assert counter.collectives == {"all-reduce": 256, "reduce-scatter": 64,
                                   "all-gather": 256}, counter.collectives
