"""The port's data-parallel training on the CPU: two gloo ranks spawned
from the test (``torch_dist_ranks.spawn``) run ``make_sharded_train_step``,
held to the JAX package's single-device ``make_train_step`` on the whole
batch.

  * reduced qwen2-0.5b, mamba2-1.3b and whisper-tiny, two steps on batches
    whose masks differ between the ranks' halves: losses and parameters
    within 1e-5 of the reference's, every rank holding the same;
  * reduced olmoe-1b-7b: the MoE load-balancing loss is each rank's own
    tokens' (ROADMAP C12), pinned: the step equals the reference's whole-
    batch cross-entropy plus the mean of the halves' aux losses, and its
    loss differs from the reference's whole-batch one;
  * the ZeRO-1 update equal to the unsharded one bit for bit on the same
    gradients, with its moments sliced.

Checkpoints across data sizes are in ``test_torch_distributed_ckpt.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.training import optimizer as joptimizer  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.training.optimizer import opt_specs  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402

torch.set_num_threads(1)
# loss and parameters after two steps, f32: the same sums in another order
# over a reduced model, and a gradient summed over two ranks
RTOL = 1e-5
ATOL = 1e-5
# eps 1e-3 keeps AdamW's update a smooth function of the gradient.  At the
# default 1e-8 an early step moves a weight by ~+-lr wherever |g| >> 1e-8, so
# a gradient element that cancels to ~1e-8 swings its weight by up to lr
# with the last bits of its sum, between any two summation orders (the
# reference's own single-device run against any other split of the batch).
ADAMW = dict(lr=1e-3, eps=1e-3, weight_decay=0.01)
DENSE = ["qwen2-0.5b", "mamba2-1.3b", "whisper-tiny"]
MOE = "olmoe-1b-7b"
B, S, STEPS = 4, 16, 2


def _batch(cfg, seed):
    """A batch of ``B`` rows whose masks differ between its halves (rank
    0's rows keep a prefix, rank 1's drop scattered positions)."""
    rng = np.random.default_rng(seed)
    n = min(cfg.decoder_seq_len, S) if cfg.family == "encdec" else S
    mask = np.ones((B, n), np.float32)
    mask[0, n // 2:] = 0.0
    mask[1, n // 4:] = 0.0
    mask[2:] = rng.random((B // 2, n)) < 0.7
    tokens = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    if cfg.family == "encdec":
        frames = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        return {"frames": frames, "dec_tokens": tokens, "labels": labels, "mask": mask}
    return {"tokens": tokens, "labels": labels, "mask": mask}


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    jcfg = jreduced(jget_config(arch))
    jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams


def _reference_run(arch, batches):
    """The reference's whole-batch steps (for the MoE arch, the pinned
    semantics: the whole batch's cross-entropy plus the mean of the two
    halves' aux losses)."""
    jcfg, jparams = _reference_params(arch)
    opt = joptimizer.AdamW(**ADAMW)
    state = opt.init(jparams)

    def pinned(p, batch):
        _, parts = jtrain.loss_fn(p, jcfg, batch)
        halves = [{k: v[i * B // 2:(i + 1) * B // 2] for k, v in batch.items()} for i in (0, 1)]
        aux = sum(jtrain.loss_fn(p, jcfg, h)[1]["aux"] for h in halves) / 2
        return parts["ce"] + jtrain.AUX_COEF * aux / jcfg.n_layers, parts

    @jax.jit
    def step(p, s, batch):
        if arch == MOE:
            (loss, _), g = jax.value_and_grad(pinned, has_aux=True)(p, batch)
            p, s = opt.update(g, s, p)
            return p, s, {"loss": loss}
        p, s, m = jtrain.make_train_step(jcfg, opt)(p, s, batch)
        return p, s, m

    losses, whole = [], []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if arch == MOE:
            whole.append(float(jtrain.loss_fn(jparams, jcfg, jb)[0]))
        jparams, state, m = step(jparams, state, jb)
        losses.append(float(m["loss"]))
    return losses, whole, jax.tree_util.tree_map(np.asarray, jparams)


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    archs = DENSE + [MOE]
    params, batches = {}, {}
    for i, arch in enumerate(archs):
        cfg = reduced_config(get_config(arch))
        params[arch] = jax.tree_util.tree_map(np.asarray, _reference_params(arch)[1])
        batches[arch] = [_batch(cfg, seed=10 * i + s) for s in range(STEPS)]
    inputs = dict(params=params, batches=batches, adamw=ADAMW, zero1_arch="qwen2-0.5b")
    outs = spawn("train", 2, tmp_path_factory.mktemp("train"), inputs)
    return inputs, outs


def _assert_params_close(got, want, what):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0, err_msg=f"{what} {i}")


@pytest.mark.parametrize("arch", DENSE)
def test_data_parallel_step_matches_reference(train_ranks, arch):
    inputs, outs = train_ranks
    losses, _, jparams = _reference_run(arch, inputs["batches"][arch])
    for r, out in enumerate(outs):
        got = [m["loss"] for m in out[arch]["metrics"]]
        np.testing.assert_allclose(got, losses, rtol=RTOL, err_msg=f"rank {r}")
        assert [m["step"] for m in out[arch]["metrics"]] == [1, 2]
        _assert_params_close(out[arch]["params"], jparams, f"{arch} rank {r}")
    for a, b in zip(tree_leaves(outs[0][arch]["params"]), tree_leaves(outs[1][arch]["params"])):
        np.testing.assert_array_equal(a, b)


def test_moe_aux_loss_is_per_rank(train_ranks):
    """C12: the aux loss of a two-rank step is the mean of the halves' own,
    where the reference's is the whole batch's; the cross-entropy, the
    pinned loss and the parameters follow the pinned semantics at 1e-5, and
    the loss differs from the reference's whole-batch loss."""
    inputs, outs = train_ranks
    losses, whole, jparams = _reference_run(MOE, inputs["batches"][MOE])
    for out in outs:
        got = [m["loss"] for m in out[MOE]["metrics"]]
        np.testing.assert_allclose(got, losses, rtol=RTOL)
        _assert_params_close(out[MOE]["params"], jparams, MOE)
    assert abs(outs[0][MOE]["metrics"][0]["loss"] - whole[0]) > 1e-6, (losses, whole)


def test_zero1_update_gives_the_unsharded_bits(train_ranks):
    _, outs = train_ranks
    for out in outs:
        z = out["zero1"]
        assert z["equal"] and all(z["equal"]), z
        assert z["sliced"] > 0 and z["local_equal"] and z["step"] == 4


def test_moments_are_sliced_by_opt_specs(train_ranks):
    """Each rank keeps its half of a moment along the dim ``opt_specs``
    gives ``data``, and the gathered moments are the whole ones."""
    inputs, outs = train_ranks
    arch = "qwen2-0.5b"
    cfg = reduced_config(get_config(arch))
    params = convert.from_jax_params(cfg, inputs["params"][arch], device="cpu")
    mesh = _FakeMesh(data=2)
    specs = opt_specs(sh.param_specs(cfg, params, mesh), params, mesh).m
    full = tree_leaves(convert.from_jax_params(cfg, outs[0][arch]["opt"].m, device="cpu"))
    for r, out in enumerate(outs):
        for spec, whole, local in zip(tree_leaves(specs), full, tree_leaves(out[arch]["local_m"])):
            if "data" in spec:
                dim = list(spec).index("data")
                rows = whole.shape[dim] // 2
                whole = whole.narrow(dim, r * rows, rows)
            np.testing.assert_array_equal(local, whole.numpy())


class _FakeMesh:
    def __init__(self, data):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": 1}
