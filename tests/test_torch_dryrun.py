"""The port's dry run (``repro_torch.launch.dryrun``, the reference's
``launch/dryrun.py``) on fake process groups, on the CPU:

  * the schema of ``tests/test_launch.py::test_artifact_schema_if_present``
    replayed on records ``run_cell`` writes for every assigned arch on
    ``pod16x16`` at full width and cut depth (two layers, jamba one
    period), the ``decode_32k`` and ``long_500k`` cells; and the
    reference's check of 30 or more cells on ``artifacts/dryrun_torch/``
    where a sweep left it;
  * FLOPs and ``bytes_accessed`` of a step on ``meta`` equal those of the
    same step on CPU tensors, exactly, per family and kind;
  * ``argument_bytes`` on a fake 4 x 4 group equals the largest local
    shard DTensor's ``distribute_tensor`` gives any rank, leaf by leaf;
  * the live-bytes tracker's peak on a scripted allocation sequence
    (views, autograd's saved tensors), and a chunked ``prefill_32k``
    attention on ``meta`` under the unchunked score tensor's bytes.

FLOPs against the reference's HLO and collective bytes against gloo ranks'
real steps are in ``test_torch_dryrun_reference.py``.  The reference's
``test_collective_bytes_parser`` and ``test_dryrun_module_sets_xla_flags_first``
have no counterpart: they test XLA's HLO text and flags, which the port
has neither of.
"""
import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ASSIGNED, get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeSpec, cell_is_runnable  # noqa: E402
from repro_torch.configs.shapes import input_specs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import flash_prefill as fk  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMALL_MESH = ((1, 1), ("data", "model"))


def _cut(arch):
    """Full width, cut depth: two layers (one period of a hybrid; two
    encoder layers for the encoder-decoder)."""
    cfg = get_config(arch)
    kw = dict(n_layers=len(cfg.hybrid_period) if cfg.hybrid_period else 2)
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = 2
    return dataclasses.replace(cfg, **kw)


def _check_schema(files):
    """``test_artifact_schema_if_present``'s body; returns the cells checked."""
    checked = 0
    for f in files:
        rec = json.loads(f.read_text())
        if not rec.get("runnable", True):
            assert "skip_reason" in rec
            continue
        assert rec.get("ok"), f"{f.name}: recorded failure {rec.get('error')}"
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert "total" in rec["collectives"]
        checked += 1
    return checked


def test_schema_replayed_on_cut_cells(tmp_path):
    for arch in ASSIGNED:
        for shape in ("decode_32k", "long_500k"):
            rec = dryrun.run_cell(arch, shape, False, tmp_path, cfg=_cut(arch))
            assert rec["mesh"] == "pod16x16"
            assert rec.get("ok", not rec["runnable"]), rec.get("traceback")
    files = sorted(tmp_path.glob("*__pod16x16.json"))
    assert len(files) == 20
    assert _check_schema(files) == 13  # 10 decode_32k + 3 long_500k
    skipped = {json.loads(f.read_text())["arch"] for f in files
               if not json.loads(f.read_text())["runnable"]}
    assert skipped == {a for a, c in ASSIGNED.items()
                       if not cell_is_runnable(c, SHAPES["long_500k"])[0]}
    # long_500k decodes KV-length-sharded on the model axis: the merge's
    # all-reduces are its collectives; the tensor-parallel ones are null
    jamba = json.loads((tmp_path / "jamba-1.5-large-398b__long_500k__pod16x16.json").read_text())
    assert jamba["kv_shard"] and jamba["collectives"]["all-reduce"] > 0
    assert jamba["collectives"]["model_tensor_parallel"] is None
    assert jamba["memory"]["generated_code_bytes"] is None and "flops" in jamba["basis"]
    dense = json.loads((tmp_path / "qwen2-0.5b__decode_32k__pod16x16.json").read_text())
    assert not dense["kv_shard"] and dense["collectives"]["total"] == 0
    assert dense["local_batch"] == SHAPES["decode_32k"].global_batch // 16


@pytest.mark.parametrize("kv_shard", [False, True])
def test_kv_shard_is_the_shapes_property(kv_shard):
    """The KV-length-sharded layout follows ``ShapeSpec.kv_shard`` (set for
    ``long_500k`` alone), whatever the shape is named: on a model axis of 2
    the flagged decode issues the merge's all-reduces, the other none."""
    assert [n for n, s in SHAPES.items() if s.kv_shard] == ["long_500k"]
    shape = ShapeSpec("decode_small", "decode", 64, 1, kv_shard=kv_shard)
    arch = "jamba-1.5-large-398b"
    rec = dryrun.run_cell(arch, shape.name, False, None, cfg=reduced_config(get_config(arch)),
                          shape=shape, mesh_shape=((1, 2), ("data", "model")))
    assert rec["ok"], rec.get("traceback")
    assert rec["kv_shard"] is kv_shard
    assert (rec["collectives"].get("all-reduce", 0) > 0) is kv_shard


def test_schema_on_swept_artifacts_if_present():
    """The reference's own check on a full sweep's records, where one was
    run in this checkout (``artifacts/`` is not committed)."""
    art = ROOT / "artifacts" / "dryrun_torch"
    files = sorted(art.glob("*__pod16x16.json")) if art.exists() else []
    if not files:
        pytest.skip("no dry-run artifacts in this checkout")
    assert _check_schema(files) >= 30


def test_roofline_of_the_records(tmp_path):
    """``benchmarks/torch_roofline.py`` on cut records: the H100's terms,
    ``model_flops`` as the reference's ``roofline.model_flops`` gives it
    for every cell of the matrix, and the fit against 80 GB."""
    from benchmarks import roofline, torch_roofline
    from repro_torch.core.perf_model import h100

    for arch in ASSIGNED:
        for shape in SHAPES:
            assert torch_roofline.model_flops(arch, shape) == roofline.model_flops(arch, shape)
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", False, tmp_path, cfg=_cut("qwen2-0.5b"))
    (cell,) = torch_roofline.load_all("pod16x16", tmp_path)
    hw = h100()
    assert cell["compute_s"] == rec["flops"] / hw.peak_flops == rec["flops"] / 989e12
    assert cell["memory_s"] == rec["bytes_accessed"] / 3.35e12
    assert cell["collective_s"] == 0 and cell["not_run"] == ["model_tensor_parallel"]
    assert cell["bottleneck"] == "memory" and 0 < cell["roofline_fraction"] < 1
    assert cell["fits"] == (rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
                            <= 80e9)
    assert torch_roofline.run(tmp_path)[0].startswith("torch-roofline/qwen2-0.5b/decode_32k,")


FAMILIES = ["qwen2-0.5b", "olmoe-1b-7b", "mamba2-1.3b", "jamba-1.5-large-398b", "whisper-tiny"]
KINDS = [("train", 32, 4), ("prefill", 32, 2), ("decode", 32, 2)]


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind,seq,batch", KINDS, ids=[k[0] for k in KINDS])
def test_meta_counts_equal_cpu_counts(arch, kind, seq, batch):
    """The step on ``meta`` dispatches what it dispatches on CPU tensors:
    FLOPs, bytes accessed, collective bytes, argument and output bytes
    equal exactly (a 2 x 2 mesh: the train step's ZeRO-1 and gradient sum
    run on the data axis).  ``temp_bytes`` is not compared: DTensor frees a
    ZeRO-1 gather's buffer at another op on CPU tensors than on ``meta``
    (it waits on the functional collective there), so a train step's peak
    moves by that buffer."""
    cfg = reduced_config(get_config(arch))
    shape = ShapeSpec(f"{kind}_small", kind, seq, batch)
    mesh = ((2, 2), ("data", "model"))
    meta = dryrun.run_cell(arch, shape.name, False, None, cfg=cfg, shape=shape, mesh_shape=mesh)
    cpu = dryrun.run_cell(arch, shape.name, False, None, cfg=cfg, shape=shape, mesh_shape=mesh,
                          device="cpu")
    assert meta["ok"] and cpu["ok"], (meta.get("traceback"), cpu.get("traceback"))
    for key in ("flops", "step_flops", "bytes_accessed", "collectives"):
        assert meta[key] == cpu[key], key
    for key in ("argument_bytes", "output_bytes"):
        assert meta["memory"][key] == cpu["memory"][key], key
    assert meta["flops"] > 0 and meta["flops"] * 2 == meta["step_flops"]
    if kind == "train":
        assert meta["collectives"]["all-reduce"] > 0 and meta["collectives"]["all-gather"] > 0


def test_argument_bytes_are_the_largest_local_shards():
    """Leaf by leaf over a 4 x 4 fake group: ``local_shape`` equals the
    largest shard ``distribute_tensor(..., to_placements(spec))`` gives any
    of the 16 ranks; ``argument_bytes`` is their sum (a decode cell:
    parameters, tokens and the state, with uneven splits: 14 heads, 151,936
    vocab rows and 2 KV heads over 4)."""
    from torch.distributed.tensor import distribute_tensor

    cfg = _cut("qwen2-0.5b")
    shape = ShapeSpec("decode_small", "decode", 64, 6)
    api = registry.get_model(cfg)
    spec = input_specs(cfg, shape)
    largest = None
    for rank in range(16):
        with dryrun.fake_mesh((4, 4), ("data", "model"), rank=rank) as mesh:
            params = api.init(cfg, device="meta")
            trees = (params, spec.batch)
            specs = (sharding.param_specs(cfg, params, mesh),
                     sharding.data_specs(cfg, spec.batch, shape.global_batch, mesh))
            got = [tuple(distribute_tensor(t, mesh, sharding.to_placements(s, mesh),
                                           src_data_rank=None).to_local().shape)
                   for t, s in zip(tree_leaves(trees), tree_leaves(specs))]
            largest = got if largest is None else [
                max(a, b, key=lambda x: torch.Size(x).numel()) for a, b in zip(largest, got)]
            if rank == 0:
                mine = [dryrun.local_shape(tuple(t.shape), s, mesh)
                        for t, s in zip(tree_leaves(trees), tree_leaves(specs))]
                sizes = [t.element_size() for t in tree_leaves(trees)]
                cell = dryrun.build_cell("qwen2-0.5b", shape.name, mesh, cfg=cfg, shape=shape)
    assert mine == largest
    assert any(a != b for a, b in zip(mine, [tuple(t.shape) for t in tree_leaves(trees)]))
    want = sum(torch.Size(s).numel() * e for s, e in zip(largest, sizes))
    assert cell.argument_bytes == want


def test_live_bytes_tracker_on_a_scripted_sequence():
    """Allocations, a view that outlives its base, and a tensor autograd
    saves whose Python name is dropped: the live bytes and the peak."""
    counter = dryrun.StepCounter()
    with counter:
        a = torch.empty(1000, device="meta")  # 4,000 live
        b = torch.empty(500, device="meta")  # 6,000
        del a  # 2,000
        c = b.view(25, 20)  # no new storage
        d = torch.empty(3000, device="meta")  # 14,000: the peak
        del b  # the view holds it
        assert counter.live == 14_000
        del c, d  # 0
        assert counter.live == 0
        x = torch.ones(250, requires_grad=True)  # 1,000
        y = x.exp()  # 2,000: autograd saves y for the backward
        z = y.sum()  # 2,004
        del y
        assert counter.live == 2_004  # y's storage is kept by the graph
        del z  # the graph goes, and y with it
        assert counter.live == 1_000
    assert counter.peak == 14_000


def test_chunked_attention_holds_no_whole_score_tensor():
    """A ``prefill_32k`` attention on ``meta`` (one sequence, qwen2-0.5b's
    14 on 2 heads of 64) through the plain path: its peak stays under an
    eighth of the unchunked f32 score tensor's bytes (the q-chunked path
    holds a few tensors of 512 query rows' scores at a time, 1/64 each)."""
    S, H, KV, hd = 32768, 14, 2, 64
    q = torch.empty(1, S, H, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, S, KV, hd, dtype=torch.bfloat16, device="meta")
    pos = torch.empty(1, S, dtype=torch.int32, device="meta")
    counter = dryrun.StepCounter()
    with counter:
        out = fk.flash_attention_plain(q, k, k, q_pos=pos, kv_pos=pos, causal=True)
    assert out.shape == q.shape
    scores = H * S * S * 4
    assert 0 < counter.peak < scores / 8, (counter.peak, scores)
