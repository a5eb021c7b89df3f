"""The port's dry-run records against what they count:

  * FLOPs against the reference's own step: the dot FLOPs of
    ``jax.jit(fn).lower(...)``'s StableHLO (``torch_hlo_flops``; the
    reference's layer scan unrolled, ``scan_unroll=True``) at reduced
    configs of every family (dense, VLM, GQA 48, MoE, SSM, hybrid,
    encoder-decoder).  Prefill and decode agree to relative 1e-9.  A
    train step counts more by a known amount, held exactly:

      - one score product ``2 B H Sq Skv hd`` per attention call: the
        flash backward (row 10) rebuilds the scores from ``lse``, where
        XLA's autodiff keeps the probabilities;
      - ``2 B L H S (2P + Q)`` per Mamba layer (``L`` padded to the chunk
        ``Q``): the SSD backward (row 11) rebuilds the chunk states, the
        ``C·B`` scores and ``y_off`` from its inputs.

    The reduced configs run no remat (``remat="none"``) and their MoE
    capacity pads alike in both packages, so neither C4's remat nor C10's
    padding shows here.
  * Collective bytes against gloo ranks' real steps (``torch_dist_ranks``
    case ``dryrun_collectives``): a (data 2, model 1) train step's
    gradient all-reduces and ZeRO-1 gathers, and a (data 1, model 2)
    KV-length-sharded decode's merge all-reduces, by op, equal the record's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs.shapes import input_specs as jinput_specs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro.training.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402
from torch_hlo_flops import hlo_dot_flops  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-9
ARCHS = ["qwen2-0.5b", "internvl2-1b", "granite-34b", "olmoe-1b-7b", "mamba2-1.3b",
         "jamba-1.5-large-398b", "whisper-tiny"]
KINDS = [("prefill", 64, 2), ("decode", 64, 2), ("train", 64, 2)]
ONE = ((1, 1), ("data", "model"))


def _reference_flops(arch, kind, seq, batch):
    """Dot FLOPs of the reference's step, the cell's function as the
    reference's ``dryrun.build_cell`` builds it."""
    cfg = dataclasses.replace(jreduced(jget_config(arch)), scan_unroll=True)
    api = jregistry.get_model(cfg)
    cell = jinput_specs(cfg, JShapeSpec(f"{kind}_small", kind, seq, batch))
    params = jax.eval_shape(lambda k: api.init(k, cfg), jax.ShapeDtypeStruct((2,), jnp.uint32))
    if kind == "train":
        opt = JAdamW(lr=1e-4)
        lowered = jax.jit(jmake_train_step(cfg, opt)).lower(
            params, jax.eval_shape(opt.init, params), cell.batch)
    elif kind == "prefill":
        def fn(p, b):
            return api.prefill(p, cfg, b.get("tokens"), b["state"], embeds=b.get("embeds"))
        lowered = jax.jit(fn).lower(params, cell.batch)
    else:
        lowered = jax.jit(lambda p, b: api.decode(p, cfg, b["tokens"], b["state"])).lower(
            params, cell.batch)
    return hlo_dot_flops(lowered.as_text())


def _train_extra(cfg, seq, batch):
    """The train step's known excess over XLA's autodiff (module docstring)."""
    def score(sq, skv):
        return 2 * batch * cfg.n_heads * sq * skv * cfg.resolved_head_dim

    if cfg.family == "encdec":
        se, sd = seq, cfg.decoder_seq_len
        return (cfg.n_encoder_layers * score(se, se)
                + cfg.n_layers * (score(sd, sd) + score(sd, se)))
    extra = cfg.n_attn_layers * score(seq, seq)
    if cfg.n_ssm_layers:
        s = cfg.ssm
        q = s.chunk
        lp = -(-seq // q) * q
        h = s.n_ssm_heads(cfg.d_model)
        extra += cfg.n_ssm_layers * 2 * batch * lp * h * s.d_state * (2 * s.head_dim + q)
    return extra


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,seq,batch", KINDS, ids=[k[0] for k in KINDS])
def test_flops_match_the_reference_hlo(arch, kind, seq, batch):
    cfg = reduced_config(get_config(arch))
    shape = ShapeSpec(f"{kind}_small", kind, seq, batch)
    rec = dryrun.run_cell(arch, shape.name, False, None, cfg=cfg, shape=shape, mesh_shape=ONE)
    assert rec["ok"], rec.get("traceback")
    want = _reference_flops(arch, kind, seq, batch)
    got = rec["step_flops"]
    assert rec["flops"] == got  # a model axis of 1
    if kind == "train":
        extra = _train_extra(cfg, seq, batch)
        assert extra > 0
        got -= extra
    assert got == pytest.approx(want, rel=RTOL, abs=0), (arch, kind, rec["step_flops"], want)


TRAIN = ShapeSpec("train_small", "train", 16, 4)
DECODE = ShapeSpec("decode_small", "decode", 64, 1, kv_shard=True)


@pytest.fixture(scope="module")
def gloo_collectives(tmp_path_factory):
    rng = np.random.default_rng(0)
    vocab = reduced_config(get_config("qwen2-0.5b")).vocab
    tokens = rng.integers(0, vocab, (TRAIN.global_batch, TRAIN.seq_len)).astype(np.int32)
    batch = dict(tokens=tokens, labels=np.roll(tokens, -1, axis=1),
                 mask=np.ones(tokens.shape, np.float32))
    inputs = dict(train_arch="qwen2-0.5b", train_batch=batch,
                  decode_arch="jamba-1.5-large-398b", decode_len=DECODE.seq_len)
    return spawn("dryrun_collectives", 2, tmp_path_factory.mktemp("dryrun_coll"), inputs)


@pytest.mark.parametrize("which", ["train", "decode"])
def test_collective_bytes_equal_the_real_steps(gloo_collectives, which):
    if which == "train":
        arch, shape, mesh = "qwen2-0.5b", TRAIN, ((2, 1), ("data", "model"))
    else:
        arch, shape, mesh = "jamba-1.5-large-398b", DECODE, ((1, 2), ("data", "model"))
    cfg = reduced_config(get_config(arch))
    rec = dryrun.run_cell(arch, shape.name, False, None, cfg=cfg, shape=shape, mesh_shape=mesh)
    assert rec["ok"], rec.get("traceback")
    coll = {k: v for k, v in rec["collectives"].items()
            if k not in ("total", "model_tensor_parallel")}
    assert rec["kv_shard"] is (which == "decode")
    for out in gloo_collectives:
        assert out[which] == coll
    assert rec["collectives"]["total"] == sum(coll.values()) > 0
    if which == "decode":
        assert set(coll) == {"all-reduce"} and rec["collectives"]["model_tensor_parallel"] is None
    else:
        assert set(coll) == {"all-reduce", "all-gather"}
