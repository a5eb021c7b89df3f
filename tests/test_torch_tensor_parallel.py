"""The port's tensor-parallel and pod-axis training on the CPU: four gloo
ranks spawned from the test (``torch_dist_ranks.spawn``, case
``tensor_parallel``) run ``make_sharded_train_step`` over (pod, data,
model) meshes, held to the JAX package's single-device ``make_train_step``
on the whole batch (the same weights through numpy, ``ADAMW`` with eps
1e-3), two steps on batches whose masks differ between the ranks' rows:

  * reduced qwen2-0.5b and llama-7b on (data 2, model 2): layout (a), the
    query and kv heads split;
  * reduced qwen2-0.5b on (data 1, model 4): layout (b), 4 query heads
    split, the 2 kv heads' head_dim split;
  * reduced qwen2-0.5b with 6 heads on (data 1, model 4): layout (c),
    every head_dim split;
  * reduced internvl2-1b with its ``embeds`` on (data 2, model 2);
  * reduced qwen2-0.5b on (pod 2, data 2, model 1): the pod axis as data
    parallelism.

Losses and gathered parameters within 1e-5 of the reference's; a leaf the
specs replicate over ``model`` equal bit for bit on every model rank; each
rank's shard equal to its slice of the gathered tensor.  On the layout (a)
and (c) runs, ``ResilientLoop``: preempted before its second step, it
resumes bit for bit from the checkpoint global rank 0 wrote from the
gathered shards; ``shard_state(gather_state(s))`` is ``s``.  Then the
vocab-sharded ``lm.nll_sums`` on 2 and 4 ranks against ``lm.cross_entropy``
and the reference's ``cross_entropy`` on the same logits, and the families
whose model axis is A11d-2's refused on a fake group.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.training import optimizer as joptimizer  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config, reduced_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train_step import make_sharded_train_step  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402

torch.set_num_threads(1)
# losses and parameters after two f32 steps: the same sums in another order
# (partial products summed over the model ranks, a two-level log-sum-exp)
RTOL = ATOL = 1e-5
# eps 1e-3 keeps AdamW's update a smooth function of the gradient
# (tests/test_torch_distributed_train.py says why)
ADAMW = dict(lr=1e-3, eps=1e-3, weight_decay=0.01)
# (name, arch, n_heads override, mesh dims: (pod,) data, model)
RUNS = [
    ("qwen2-0.5b", "qwen2-0.5b", None, (2, 2)),
    ("llama-7b", "llama-7b", None, (2, 2)),
    ("qwen2-0.5b/model4", "qwen2-0.5b", None, (1, 4)),
    ("qwen2-0.5b/heads6", "qwen2-0.5b", 6, (1, 4)),
    ("internvl2-1b", "internvl2-1b", None, (2, 2)),
    ("qwen2-0.5b/pod2", "qwen2-0.5b", None, (2, 2, 1)),
]
LAYOUTS = {"qwen2-0.5b": "a", "llama-7b": "a", "qwen2-0.5b/model4": "b",
           "qwen2-0.5b/heads6": "c", "internvl2-1b": "a", "qwen2-0.5b/pod2": None}
B, S, STEPS = 4, 16, 2
# the runs that also go through ResilientLoop: (data 2, model 2), layout
# (a), and (data 1, model 4), layout (c)
LOOP_RUNS = ["qwen2-0.5b", "qwen2-0.5b/heads6"]


def _cfgs(arch, heads):
    jcfg, cfg = jreduced(jget_config(arch)), reduced_config(get_config(arch))
    if heads:
        jcfg = dataclasses.replace(jcfg, n_heads=heads)
        cfg = dataclasses.replace(cfg, n_heads=heads)
    return jcfg, cfg


def _batch(cfg, seed):
    """``B`` rows whose masks differ between the rows each batch rank
    takes (a prefix kept, a shorter prefix, scattered positions)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.float32)
    mask[0, S // 2:] = 0.0
    mask[1, S // 4:] = 0.0
    mask[2:] = rng.random((B - 2, S)) < 0.7
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32), "mask": mask}
    if cfg.family == "vlm":
        ft = cfg.frontend_tokens
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S - ft)).astype(np.int32)
        batch["embeds"] = (rng.standard_normal((B, ft, cfg.d_model)) * 0.02).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return batch


def _reference(jcfg, jparams, batches):
    opt = joptimizer.AdamW(**ADAMW)
    state = opt.init(jparams)
    step = jax.jit(jtrain.make_train_step(jcfg, opt))
    losses = []
    for b in batches:
        jparams, state, m = step(jparams, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, jparams)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params, batches, want = {}, {}, {}
    for i, (name, arch, heads, _) in enumerate(RUNS):
        jcfg, cfg = _cfgs(arch, heads)
        jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(i), jcfg)
        params[name] = jax.tree_util.tree_map(np.asarray, jparams)
        batches[name] = [_batch(cfg, 10 * i + s) for s in range(STEPS)]
        want[name] = _reference(jcfg, jparams, batches[name])
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((2, 6, 512)) * 4).astype(np.float32)
    inputs = dict(runs=RUNS, params=params, batches=batches, adamw=ADAMW, logits=logits,
                  labels=rng.integers(0, 512, (2, 6)).astype(np.int32),
                  mask=(rng.random((2, 6)) < 0.6).astype(np.float32))
    workdir = tmp_path_factory.mktemp("tp")
    inputs.update(loop_runs=LOOP_RUNS, dir=str(workdir / "loops"))
    outs = spawn("tensor_parallel", 4, workdir, inputs)
    return inputs, want, outs


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_step_matches_the_reference(ranks, name):
    _, want, outs = ranks
    losses, jparams = want[name]
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[name]["losses"], losses, rtol=RTOL, err_msg=f"rank {r}")
        got = tree_leaves(out[name]["params"])
        ref = jax.tree_util.tree_leaves(jparams)
        assert len(got) == len(ref)
        for i, (g, w) in enumerate(zip(got, ref)):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{name} leaf {i}")


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_shards_and_replicated_leaves(ranks, name):
    """Each local shard is its slice of the gathered tensor along the dim
    its spec names ``model``; a leaf whose spec names no ``model`` dim holds
    the same bits on every rank of a model group."""
    _, _, outs = ranks
    _, cfg = _cfgs(*next((a, h) for n, a, h, _ in RUNS if n == name))
    groups = {}
    for r, out in enumerate(outs):
        run = out[name]
        whole = tree_leaves(convert.from_jax_params(cfg, run["params"], device="cpu"))
        replicated = []
        for spec, local, full in zip(run["specs"], tree_leaves(run["local"]), whole):
            if "model" not in spec:
                replicated.append(local)
                continue
            d, n = spec.index("model"), local.shape[spec.index("model")]
            first = run["model_rank"] * n
            np.testing.assert_array_equal(local, full.numpy().take(range(first, first + n),
                                                                   axis=d))
        assert replicated  # the norms at least
        # a model group's ranks share their coordinates on the other axes
        groups.setdefault(r - run["model_rank"], []).append(replicated)
    for group in groups.values():
        for other in group[1:]:
            for a, b in zip(group[0], other):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", LOOP_RUNS)
def test_preempted_loop_resumes_bit_for_bit(ranks, name):
    """On every rank the loop's shards equal the step's own run, and the
    preempted loop's resumed shards and moment slices the whole loop's."""
    _, _, outs = ranks
    for r, out in enumerate(outs):
        loop = out[("loop", name)]
        assert loop["preempted"], r
        assert loop["whole_is_the_step"] and all(loop["whole_is_the_step"]), r
        assert loop["resume_equal"] and all(loop["resume_equal"]), (r, loop["resume_equal"])


@pytest.mark.parametrize("name", LOOP_RUNS)
def test_state_shards_round_trip(ranks, name):
    """``shard_state(gather_state(s))`` and ``shard_params(gather_params(p))``
    give every rank its own slices back, bit for bit."""
    _, _, outs = ranks
    for r, out in enumerate(outs):
        loop = out[("loop", name)]
        for key in ("state_round_trip", "params_round_trip"):
            assert loop[key] and all(loop[key]), (r, key)


@pytest.mark.parametrize("name", [n for n, layout in LAYOUTS.items() if layout])
def test_runs_take_their_layouts(name):
    """The specs of each model-axis run lay its attention out as named."""
    arch, heads, dims = next((a, h, d) for n, a, h, d in RUNS if n == name)
    _, cfg = _cfgs(arch, heads)
    mesh = _FakeMesh(dims)
    attn = sharding.param_specs(cfg, lm.init(cfg, device="meta"), mesh)["layers"][0]["attn"]
    got = {k: tuple(attn[k]) for k in ("wq", "wk", "wo")}
    want = {"a": {"wq": (None, "model", None), "wk": (None, "model", None),
                  "wo": ("model", None, None)},
            "b": {"wq": (None, "model", None), "wk": (None, None, "model"),
                  "wo": ("model", None, None)},
            "c": {"wq": (None, None, "model"), "wk": (None, None, "model"),
                  "wo": (None, "model", None)}}[LAYOUTS[name]]
    assert got == want, (name, got)


class _FakeMesh:
    def __init__(self, dims):
        self.axis_names = ("pod", "data", "model")[-len(dims):]
        self.shape = dict(zip(self.axis_names, dims))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_vocab_sharded_nll_sums(ranks, n, masked):
    inputs, _, outs = ranks
    logits, labels = torch.from_numpy(inputs["logits"]), torch.from_numpy(inputs["labels"])
    mask = torch.from_numpy(inputs["mask"]) if masked else None
    want_ce = float(lm.cross_entropy(logits, labels, mask))
    jce = float(jlm.cross_entropy(jnp.asarray(inputs["logits"]), jnp.asarray(inputs["labels"]),
                                  None if mask is None else jnp.asarray(inputs["mask"])))
    for r in range(n):
        total, count = outs[r][("nll", n, masked)]
        ce = total / max(count, 1.0)
        assert count == (float(mask.sum()) if masked else labels.numel())
        assert ce == pytest.approx(want_ce, rel=1e-6, abs=1e-6)
        assert ce == pytest.approx(jce, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-1.3b", "whisper-tiny", "granite-34b"])
def test_other_families_are_refused(arch):
    """A model axis of 2 raises the A11d-2 error for the MoE, SSM and
    encoder-decoder families and an FSDP arch (granite-34b at full size:
    ``reduced_config`` makes every arch ``dp``; the step reads only the
    shapes, on ``meta``)."""
    cfg = get_config(arch)
    assert arch in ASSIGNED
    with dryrun.fake_mesh((1, 2), ("data", "model")) as mesh:
        with pytest.raises(ValueError, match="A11d-2"):
            make_sharded_train_step(cfg, AdamW(), mesh)


@pytest.mark.parametrize("heads,kv,ranks", [(4, 2, 4), (14, 2, 2), (48, 8, 16), (12, 4, 3),
                                            (6, 2, 3)])
def test_kv_heads_of_each_ranks_query_heads(heads, kv, ranks):
    """Layout (b)'s selection: every rank's query heads meet the kv head
    the unsharded grouping gives them (``G = heads / kv`` query heads a kv
    head), also where a rank's query heads straddle kv heads unevenly."""
    from repro_torch.models.attention import _kv_heads_of

    G, n_q = heads // kv, heads // ranks
    t = torch.arange(kv, dtype=torch.float32)[None, None, :, None].expand(1, 3, kv, 2)
    for r in range(ranks):
        got = _kv_heads_of(t, r * n_q, n_q, G)
        per = n_q // got.shape[2]
        for i in range(n_q):
            assert float(got[0, 0, i // per, 0]) == (r * n_q + i) // G, (r, i)


def test_operators_without_a_group_are_the_identity():
    from repro_torch.distributed import tensor_parallel as tp

    x = torch.randn(2, 3, 4, requires_grad=True)
    for op in (tp.copy_to_model, tp.reduce_from_model, tp.gather_last_dim, tp.split_last_dim,
               tp.all_max):
        assert torch.equal(op(x, None), x)
    assert tp.shard_count(4, 4, None) == 1
    with pytest.raises(ValueError):
        tp.shard_count(3, 4, None)
