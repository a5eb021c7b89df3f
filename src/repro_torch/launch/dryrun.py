"""The dry run: FLOPs, bytes and collective bytes per device for every
(architecture x input shape x mesh) cell, from steps run on ``meta``
tensors (the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell's step over 512 forced host
devices and reads XLA's ``memory_analysis``, ``cost_analysis`` and the
collectives of the optimised HLO.  The port has no XLA and no HLO, so it
runs the step itself, once and eagerly, on ``meta`` tensors (shapes and
dtypes, nothing allocated): the model from ``init(cfg, device="meta")``,
the batch from ``configs.shapes.input_specs``, at one data shard's batch
(``global_batch`` over the batch axes ``sharding.data_specs`` splits it
on).  The process group is a fake one of the mesh's size in this one
process (``torch.testing``'s ``FakeStore`` and the ``"fake"`` backend):
its collectives move nothing, and the meshes of ``launch/mesh.py``'s
shapes are built on it, as rank 0.  A train cell of a dense ``dp`` arch
(``train_step.runs_model_axis``) runs the step on the whole mesh: this
rank's ``model`` shards of the parameters (``tensor_parallel``) and its
rows of the batch over ``("pod", "data")``.  The other cells run whole on
every rank of the ``model`` axis: the other families' train steps on the
``data`` sub-mesh at a pod's rows (ROADMAP A11d-2), prefill and decode
unsharded but for a ``kv_shard`` shape's attention (tensor-parallel
serving is not run).  Each cell's record, in the reference's schema:

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
    model rank's own step (matmuls, convolutions, attention products) where
    the step runs the model axis; elsewhere the data shard's step over the
    ``model`` axis's size (the ideal split, not run).  ``step_flops`` is
    the data shard's whole step unsplit in both;
  * ``bytes_accessed``: the inputs' and outputs' bytes of every op the
    step dispatches but views (``StepCounter``), each hand-written kernel
    one op (``kernels_as_ops``: its plain version's intermediates live in
    the kernel's registers on the card): what an eager step on the card
    moves through HBM, caches ignored;
  * ``collectives``: the output bytes of every collective the step calls
    on the fake group, by op (``all-reduce``, ``all-gather``, ...) and
    ``total``: the data axis's gradient all-reduce and ZeRO-1 gathers of a
    train step, the KV-length-sharded merge's all-reduces of a decode
    whose shape has ``kv_shard`` (``long_500k``).  Where the step runs the
    model axis, ``model_tensor_parallel`` and ``pod_gradient_sync`` are
    the bytes of those it calls on the ``model`` and ``pod`` groups (told
    apart by the process group each op receives; part of ``total``).
    Where the port does not run them (the other families' train cells,
    every prefill and decode cell's tensor parallelism) they are null,
    with the reason under ``not_run``, not estimated;
  * ``memory``: ``argument_bytes`` and ``output_bytes``, each leaf's
    largest local shard over the ranks under ``param_specs``,
    ``opt_specs``, ``data_specs`` and ``state_specs`` (through
    ``to_placements``' DTensor chunks); ``temp_bytes``, the peak of the
    storages the step allocates and still holds (``StepCounter``; a
    kernel's outputs, not its plain version's intermediates): the model
    rank's own activations where the step runs the model axis, else the
    activations whole on every rank of it;
    ``generated_code_bytes`` null;
  * ``basis``: what each field rests on.

There is no counterpart of the reference's ``calibrate_cell``: XLA's
``cost_analysis`` counts a scanned layer's body once, so the reference
compiles unrolled one- and two-period variants to extrapolate, where an
eager run on ``meta`` dispatches every layer and counts each.

Records go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``,
which ``benchmarks/torch_roofline.py`` reads:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, cell_is_runnable
from repro_torch.configs.shapes import META, input_specs
from repro_torch.distributed import sharding
from repro_torch.kernels import chunked_prefill as cpk
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_backward as fbk
from repro_torch.kernels import flash_prefill as fk
from repro_torch.kernels import fused_prefill as fuk
from repro_torch.kernels import kv_quant as kq
from repro_torch.kernels import packed_prefill as pk
from repro_torch.kernels import paged_decode as pdk
from repro_torch.kernels import ssd_scan as ssk
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import lm, registry
from repro_torch.training.optimizer import AdamW, opt_specs
from repro_torch.training.train_step import make_sharded_train_step, runs_model_axis
from repro_torch.training.tree import tree_leaves

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# c10d and functional-collective op names -> the reference's HLO op names
_COLLECTIVES = (
    ("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
    ("all_reduce", "all-reduce"), ("allgather", "all-gather"), ("all_gather", "all-gather"),
    ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"), ("broadcast", "broadcast"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
)
# why a record's model or pod entry is null: what the port does not run
_NOT_RUN = {
    "pod_gradient_sync": "this family's train step on a pod axis is not run by the port "
                         "(make_sharded_train_step raises; ROADMAP A11d-2)",
    "model_tensor_parallel": "this family's tensor-parallel train step is not run by the port "
                             "(make_sharded_train_step raises on a model axis > 1; ROADMAP "
                             "A11d-2)",
}
_NOT_RUN_SERVING = ("tensor-parallel prefill and decode are not run by the port (ROADMAP: "
                    "tensor-parallel serving)")


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def collective_kind(op: Any) -> Optional[str]:
    """The reference's name of a dispatched collective op, or None."""
    ns = op.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = op._opname
    for key, kind in _COLLECTIVES:
        if key in name:
            return kind
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


# ops that move no bytes: a functional collective's wait
_NO_TRAFFIC = {torch.ops._c10d_functional.wait_tensor.default}


def _group_name(func: Any, args: Any, kwargs: Dict[str, Any]) -> Optional[str]:
    """The process group a collective op receives, found by the op's
    schema: a c10d op's ``ProcessGroup`` argument, a functional
    collective's ``group_name`` (its other strings are reduce ops)."""
    for i, arg in enumerate(func._schema.arguments):
        a = args[i] if i < len(args) else kwargs.get(arg.name)
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name().endswith(
                ".ProcessGroup"):
            return dist.ProcessGroup.unbox(a).group_name
        if arg.name == "group_name":
            return a
    return None


def _from_host(func, ins, outs) -> bool:
    return (func is torch.ops.aten._to_copy.default and ins[0].device.type == "cpu"
            and outs[0].device.type != "cpu")


class StepCounter(TorchDispatchMode):
    """Counts what a step moves and holds, op by op, on any device.

    ``bytes_accessed``: the bytes of every tensor input and output of each
    dispatched op but views.  ``collectives``: each collective's output
    bytes by the reference's op name.  ``live`` / ``peak``: the bytes of
    the storages the step's ops allocated and that are still alive, and
    their peak.  ``by_group``: the collectives' bytes under the names
    ``groups`` gives their process groups (``group_name`` -> name).  A
    storage counts from the op that makes it until its last
    tensor dies: each of its tensors (views included) holds it through a
    finalizer, and autograd keeps the Python object of a tensor it saves
    alive with it; a storage whose tensors are gone but that some other
    reference still holds is checked again after every op until it is
    freed."""

    def __init__(self, groups: Optional[Dict[str, str]] = None):
        super().__init__()
        self.bytes_accessed = 0
        self.collectives: Dict[str, int] = {}
        self.groups = groups or {}
        self.by_group: Dict[str, int] = {}
        self._live = 0
        self.peak = 0
        self._depth = 0  # inside a kernel's plain version
        self._held: Dict[int, list] = {}  # storage key -> [tensors alive, nbytes, weak ref]
        self._waiting: Dict[int, list] = {}

    def _release(self, key: int) -> None:
        entry = self._held.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            del self._held[key]
            self._waiting[key] = entry

    def _sweep(self) -> None:
        for key in [k for k, e in self._waiting.items() if e[2].expired()]:
            self._live -= self._waiting.pop(key)[1]

    @property
    def live(self) -> int:
        self._sweep()
        return self._live

    def _hold(self, t: torch.Tensor, inputs: set) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in inputs:
            entry = self._held.get(key)
            if entry is None:
                return  # a view of an argument or of an untracked tensor
            entry[0] += 1
        elif key in self._held:
            self._held[key][0] += 1
        else:
            nbytes = st.nbytes()
            self._held[key] = [1, nbytes, StorageWeakRef(st)]
            self._live += nbytes
            self.peak = max(self.peak, self._live)
        weakref.finalize(t, self._release, key)

    @contextlib.contextmanager
    def kernel(self, args: Any) -> Iterator[list]:
        """One hand-written kernel's plain version as one op: the ops inside
        move and hold nothing of their own (on the card they run in the
        kernel's registers and shared memory); the kernel reads its tensor
        arguments and writes its outputs, which the caller appends to the
        list this yields."""
        outs: list = []
        self._depth += 1
        try:
            yield outs
        finally:
            self._depth -= 1
        if self._depth == 0:
            self._op(_tensors(args), _tensors(outs), moves=True)

    def _op(self, ins: list, outs: list, moves: bool) -> None:
        """Count one op: its bytes where it ``moves`` any, its new storages."""
        if moves:
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self._sweep()
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            self._hold(t, in_keys)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if _from_host(func, ins, outs):
            # a host constant's copy to the device (RoPE's numpy-built
            # frequencies): on CPU tensors no op runs, so it is the step's
            # argument, not its work
            return out
        kind = collective_kind(func)
        if kind is not None:
            nbytes = sum(map(_nbytes, outs))
            self.collectives[kind] = self.collectives.get(kind, 0) + nbytes
            name = self.groups.get(_group_name(func, args, kwargs))
            if name is not None:
                self.by_group[name] = self.by_group.get(name, 0) + nbytes
        self._op(ins, outs, moves=not func.is_view and func not in _NO_TRAFFIC)
        return out


# the plain versions ``kernels/ops.py`` runs off the card, one per
# hand-written kernel (the module and the function's name)
KERNEL_PLAINS = (
    (fk, "flash_attention_plain"), (dk, "decode_attention_plain"),
    (pk, "packed_flash_attention_plain"), (pdk, "paged_decode_attention_plain"),
    (cpk, "chunked_prefill_attention_plain"), (fuk, "fused_flash_attention_plain"),
    (kq, "kv_quant_plain"), (kq, "kv_dequant_plain"), (ssk, "ssd_chunked_plain"),
    (ssk, "ssd_chunked_bwd_plain"), (fbk, "flash_attention_fwd_plain"),
    (fbk, "flash_attention_bwd_plain"),
)


@contextlib.contextmanager
def kernels_as_ops(counter: StepCounter) -> Iterator[None]:
    """Within the block every kernel's plain version counts as one op of
    ``counter`` (``StepCounter.kernel``): its arguments read, its outputs
    written, nothing held between.  FLOPs still count every product inside
    (``FlopCounterMode`` is a mode of its own)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in KERNEL_PLAINS]

    def as_op(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with counter.kernel((args, kwargs)) as outs:
                out = fn(*args, **kwargs)
                outs.append(out)
            return out
        return call

    for mod, name, fn in saved:
        setattr(mod, name, as_op(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# --------------------------------------------------------------------------- #
# Meshes on a fake process group
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], rank: int = 0) -> Iterator[Any]:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on a fake process group
    of ``prod(shape)`` ranks in this process (as ``rank``), destroyed when
    the block ends.  Raises if a process group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# Local shards under the specs
# --------------------------------------------------------------------------- #
def local_shape(shape: Tuple[int, ...], spec: Any, mesh: Any) -> Tuple[int, ...]:
    """The largest local shape over the ranks of a tensor of ``shape`` laid
    out by ``spec`` on ``mesh``: DTensor's chunks (``to_placements``), the
    first rank's along every sharded dim, mesh dims in order."""
    out = list(shape)
    sizes = sharding.mesh_axes(mesh)
    for name, placement in zip(mesh.mesh_dim_names, sharding.to_placements(spec, mesh)):
        if placement.is_shard():
            d = placement.dim
            out[d] = -(-out[d] // sizes[name])
    return tuple(out)


def local_bytes(tree: Any, specs: Any, mesh: Any) -> int:
    """The summed bytes of every leaf's largest local shard."""
    leaves, spec_leaves = tree_leaves(tree), tree_leaves(specs)
    assert len(leaves) == len(spec_leaves), (len(leaves), len(spec_leaves))
    return sum(math.prod(local_shape(tuple(t.shape), s, mesh)) * t.element_size()
               for t, s in zip(leaves, spec_leaves))


# --------------------------------------------------------------------------- #
# Cells
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Cell:
    """A cell's step on ``meta`` tensors: ``run()`` runs it once; the
    argument and output bytes are per device under the specs.  A train
    step that runs the model axis names its groups (a ``group_name`` -> the
    record's key) and ``unsplit()``, the data shard's whole step (its
    FLOPs are the record's ``step_flops``)."""

    run: Callable[[], Any]
    argument_bytes: int
    output_bytes: int
    local_batch: int
    kv_shard: bool
    groups: Optional[Dict[str, str]] = None
    unsplit: Optional[Callable[[], Any]] = None


def _rows(tree: Any, n: int, device: torch.device) -> Any:
    """The first ``n`` rows (batch dim) of every leaf of a batch, on
    ``device`` (zeros where that is not ``meta``)."""
    if isinstance(tree, torch.Tensor):
        t = tree[:n]
        return t if device == META else torch.zeros(t.shape, dtype=t.dtype, device=device)
    if isinstance(tree, dict):
        return {k: _rows(v, n, device) for k, v in tree.items()}
    return tree


def build_cell(arch: str, shape_name: str, mesh: Any, *, cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeSpec] = None, device: Any = META) -> Cell:
    """The cell's step at one data shard's batch, and its bytes per device.
    ``cfg`` and ``shape`` replace the arch's and the shape's (a cut
    config or batch).  On a ``device`` other than ``meta`` the step runs
    on real tensors: random weights, zero inputs (the counts' check)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    device = torch.device(device)
    spec = input_specs(cfg, shape)
    api = registry.get_model(cfg)
    axes = sharding.mesh_axes(mesh)
    gb = shape.global_batch
    bsize = math.prod(axes[a] for a in sharding.batch_axes(mesh))
    local = gb // bsize if gb % bsize == 0 else gb
    params = api.init(cfg, device=device)
    p_specs = sharding.param_specs(cfg, params, mesh)
    d_specs = sharding.data_specs(cfg, spec.batch, gb, mesh, kv_shard=shape.kv_shard)
    arg_bytes = local_bytes(params, p_specs, mesh) + local_bytes(spec.batch, d_specs, mesh)

    if spec.kind == "train":
        opt = AdamW(lr=1e-4)
        o_specs = opt_specs(p_specs, params, mesh)
        state_bytes = 2 * local_bytes(_f32(params), o_specs.m, mesh)
        out_bytes = local_bytes(params, p_specs, mesh) + state_bytes

        def data_step():
            """The step on the ``data`` sub-mesh at a pod's rows: the
            parameters whole, the model and pod axes not run."""
            sub = mesh[sharding.DATA] if sharding.DATA in axes else mesh
            step = make_sharded_train_step(cfg, opt, sub)
            opt_state = step.init(params)
            batch = _rows(spec.batch, gb // axes.get(sharding.POD, 1), device)
            return lambda: step(params, opt_state, batch)

        if not runs_model_axis(cfg):
            return Cell(data_step(), arg_bytes + state_bytes, out_bytes, local, False)
        step = make_sharded_train_step(cfg, opt, mesh)
        mine = step.shard_params(params)
        opt_state = step.init(mine)
        batch = _rows(spec.batch, gb, device)
        groups = {mesh.get_group(a).group_name: key
                  for a, key in ((sharding.MODEL, "model_tensor_parallel"),
                                 (sharding.POD, "pod_gradient_sync")) if axes.get(a, 1) > 1}
        return Cell(lambda: step(mine, opt_state, batch), arg_bytes + state_bytes, out_bytes,
                    local, False, groups=groups,
                    unsplit=data_step() if axes.get(sharding.MODEL, 1) > 1 else None)

    # the state at the local batch, as input_specs lays it out at the global one
    group = None
    batch = _rows({k: v for k, v in spec.batch.items() if k != "state"}, local, device)
    if cfg.family == "encdec":
        prefill = spec.kind == "prefill"
        state = api.init_state(cfg, local, cfg.decoder_seq_len if prefill else shape.seq_len,
                               device=device,
                               enc_len=shape.seq_len if prefill else cfg.encoder_seq_len)
    else:
        state = api.init_state(cfg, local, shape.seq_len, device=device)
        if shape.kv_shard and axes.get(sharding.MODEL, 1) > 1:
            group = mesh.get_group(sharding.MODEL)
            shard = lm.shard_state(state, group)
            state, group = (state, None) if shard is None else (shard, group)
    kw = {} if group is None else {"kv_group": group}
    logits_bytes = local * cfg.vocab * 4
    out_bytes = logits_bytes + local_bytes(spec.batch["state"], d_specs["state"], mesh)

    if spec.kind == "prefill":
        def run():
            with torch.no_grad():
                return api.prefill(params, cfg, batch.get("tokens"), state,
                                   embeds=batch.get("embeds"), **kw)
    else:
        def run():
            with torch.no_grad():
                return api.decode(params, cfg, batch["tokens"], state, **kw)
    return Cell(run, arg_bytes, out_bytes, local, group is not None)


def _f32(tree: Any) -> Any:
    """Meta f32 tensors of ``tree``'s shapes (the moments' dtype)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=torch.float32, device=META)
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_f32(v) for v in tree)
    return tree


BASIS = {
    "flops": "FlopCounterMode over the eager meta step of model rank 0 at one batch shard "
             "(the dense dp archs' train cells); elsewhere the data shard's step divided by "
             "the model axis's size (the ideal split: that model axis is not run)",
    "bytes_accessed": "inputs' and outputs' bytes of every dispatched op but views, each "
                      "hand-written kernel one op (an eager step's HBM traffic on the card, "
                      "caches ignored): model rank 0's own where the step runs the model "
                      "axis, else activations whole on every model rank",
    "collectives": "output bytes of the c10d / functional collectives the port's step "
                   "calls on the fake group, by op; model_tensor_parallel and "
                   "pod_gradient_sync: those on the model and pod groups; null where the "
                   "port does not run them (not_run says why)",
    "memory.argument_bytes": "each input leaf's largest local shard under param_specs, "
                             "opt_specs (f32 moments), data_specs and state_specs",
    "memory.output_bytes": "parameters and moments (train) or f32 logits at the local "
                           "batch and the state (prefill, decode), largest local shards",
    "memory.temp_bytes": "peak of the live storages the step allocates (views and "
                         "autograd's saved tensors followed to their storage; a kernel's "
                         "outputs, not its plain version's intermediates): model rank 0's "
                         "own where the step runs the model axis, else activations whole "
                         "on every model rank",
    "memory.generated_code_bytes": "no compiled program: null",
}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Optional[Path],
             tag: str = "", *, cfg: Optional[ArchConfig] = None,
             shape: Optional[ShapeSpec] = None,
             mesh_shape: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]] = None,
             device: Any = META) -> dict:
    """Run one cell on a fake process group and return its record, written
    to ``out_dir`` where given.  ``cfg``, ``shape`` and ``mesh_shape``
    (``(shape, axis names)``) replace the arch's config, the shape and the
    production mesh (a cut cell, or a small mesh); ``device`` is
    ``build_cell``'s."""
    name = mesh_name(multi_pod)
    shape = shape or SHAPES[shape_name]
    cfg = cfg or get_config(arch)
    dims, axes = mesh_shape or production_mesh_shape(multi_pod)
    if mesh_shape is not None:
        name = "x".join(f"{a}{n}" for a, n in zip(axes, dims))
    ok, why = cell_is_runnable(cfg, shape)
    record = {"arch": arch, "shape": shape_name, "mesh": name, "kind": shape.kind,
              "runnable": ok}
    suffix = f"__{tag}" if tag else ""
    out_path = (None if out_dir is None
                else Path(out_dir) / f"{arch}__{shape_name}__{name}{suffix}.json")
    if not ok:
        record["skip_reason"] = why
        if out_path is not None:
            out_path.write_text(json.dumps(record, indent=2))
        return record
    t0 = time.time()
    try:
        with fake_mesh(dims, axes) as mesh:
            cell = build_cell(arch, shape_name, mesh, cfg=cfg, shape=shape, device=device)
            counter = StepCounter(cell.groups)
            flops = FlopCounterMode(display=False)
            with flops, counter, kernels_as_ops(counter):
                result = cell.run()
            del result
            own_flops = step_flops = flops.get_total_flops()
            if cell.unsplit is not None:
                unsplit = FlopCounterMode(display=False)
                with unsplit:
                    cell.unsplit()
                step_flops = unsplit.get_total_flops()
            model = sharding.axis_size(mesh, sharding.MODEL)
            pods = sharding.axis_size(mesh, sharding.POD)
        coll = dict(counter.collectives)
        coll["total"] = sum(coll.values())
        not_run = {}
        if cell.groups is not None:  # the step runs the model axis
            for key, size in (("model_tensor_parallel", model), ("pod_gradient_sync", pods)):
                if size > 1:
                    coll[key] = counter.by_group.get(key, 0)
        else:
            if model > 1:
                coll["model_tensor_parallel"] = None
                not_run["model_tensor_parallel"] = (_NOT_RUN["model_tensor_parallel"]
                                                    if shape.kind == "train"
                                                    else _NOT_RUN_SERVING)
            if pods > 1 and shape.kind == "train":
                coll["pod_gradient_sync"] = None
                not_run["pod_gradient_sync"] = _NOT_RUN["pod_gradient_sync"]
        record.update(
            ok=True,
            trace_s=round(time.time() - t0, 3),
            flops=own_flops if cell.groups is not None else step_flops / model,
            step_flops=step_flops,
            bytes_accessed=float(counter.bytes_accessed),
            collectives=coll,
            memory={"argument_bytes": cell.argument_bytes, "output_bytes": cell.output_bytes,
                    "temp_bytes": counter.peak, "generated_code_bytes": None},
            local_batch=cell.local_batch,
            kv_shard=cell.kv_shard,
            not_run=not_run,
            basis=BASIS,
        )
        print(f"[dryrun] OK  {arch:24s} {shape_name:12s} {name:10s} "
              f"flops={record['flops']:.3e} coll={coll['total'] / 1e9:.2f}GB "
              f"trace={record['trace_s']:.1f}s")
    except Exception as e:  # noqa: BLE001 — record the cell's failure and keep sweeping
        record.update(ok=False, error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] FAIL {arch} {shape_name} {name}: {e}")
    if out_path is not None:
        out_path.write_text(json.dumps(record, indent=2))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the port's dry run over fake process groups")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="", help="artifact suffix")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list(ASSIGNED) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_ok = n_fail = n_skip = 0
    t0 = time.time()
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                suffix = f"__{args.tag}" if args.tag else ""
                f = out_dir / f"{arch}__{shape_name}__{mesh_name(multi)}{suffix}.json"
                if args.skip_existing and f.exists():
                    prev = json.loads(f.read_text())
                    if prev.get("ok") or not prev.get("runnable", True):
                        continue
                rec = run_cell(arch, shape_name, multi, out_dir, tag=args.tag)
                if not rec.get("runnable", True):
                    n_skip += 1
                elif rec.get("ok"):
                    n_ok += 1
                else:
                    n_fail += 1
    print(f"[dryrun] done: ok={n_ok} fail={n_fail} documented-skips={n_skip} "
          f"wall={time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
