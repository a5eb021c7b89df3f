"""Ranks of a gloo group for the port's distribution tests on the CPU.

``spawn(case, world, workdir, inputs)`` starts ``world`` processes of this
file, one per rank, joined in a gloo process group through a ``FileStore``
in ``workdir``; each runs ``CASES[case]`` on the inputs the test pickled
there and pickles what it saw for the test to check.  The ranks import
torch and ``repro_torch`` only (no JAX): the test computes the reference's
side in its own process.

    python tests/torch_dist_ranks.py CASE RANK WORLD WORKDIR
"""
from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def spawn(case: str, world: int, workdir: pathlib.Path, inputs: dict, timeout: float = 300):
    """Run ``case`` on ``world`` ranks; returns each rank's output, by rank.
    Raises with the ranks' error output if any rank fails or the group
    outlives ``timeout`` seconds (every rank is killed then)."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world), str(workdir)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, f"ranks {failed} failed:\n" + "\n".join(logs)
    outs = []
    for r in range(world):
        with open(workdir / f"out_{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


# --------------------------------------------------------------------------- #
# Cases (run in the rank processes)
# --------------------------------------------------------------------------- #
def _np(tree):
    """Tensors in a nested dict / list / tuple as numpy."""
    import torch

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return tree


def _shard_rows(t, rank: int, n: int):
    """Rank ``rank`` of ``n``'s equal part of the kv rows (dim 1) of ``t``."""
    rows = t.shape[1] // n
    return t[:, rank * rows:(rank + 1) * rows]


def case_collectives(rank: int, world: int, inputs: dict) -> dict:
    """``compressed_pmean`` on groups of 1, 2 and 4 ranks and through
    ``make_compressed_grad_sync`` over a (pod 2, data 2) mesh; the
    KV-sharded ``flash_attention`` and ``decode_attention`` on groups of 1,
    2 and 4 ranks, each rank holding its part of the kv rows."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import ops
    from repro_torch.training.compression import compressed_pmean, make_compressed_grad_sync

    out = {}
    groups = {n: dist.new_group(list(range(n))) for n in (1, 2, 4)}
    for n, group in groups.items():
        if rank < n:
            x = torch.from_numpy(inputs["grads"][rank])
            out[("pmean", n)] = compressed_pmean(x, group).numpy()

    mesh = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
    tree = {"w": torch.from_numpy(inputs["grads"][rank]), "b": [torch.from_numpy(
        inputs["grads"][rank][0])]}
    out["sync"] = _np(make_compressed_grad_sync(mesh)(tree))
    out["pod_ranks"] = dist.get_process_group_ranks(mesh.get_group("pod"))
    flat = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    out["no_pod_is_identity"] = make_compressed_grad_sync(flat)(tree) is tree

    for n in (1, 2, 4):
        if rank >= n:
            continue
        for name, case in inputs["attention"].items():
            q, k, v, q_pos, kv_pos = (torch.from_numpy(case[x]) for x in
                                      ("q", "k", "v", "q_pos", "kv_pos"))
            kw = dict(q_pos=q_pos, kv_pos=_shard_rows(kv_pos, rank, n), window=case["window"],
                      kv_group=groups[n])
            k, v = _shard_rows(k, rank, n), _shard_rows(v, rank, n)
            if case["decode"]:
                got = ops.decode_attention(q, k, v, **kw)
            else:
                got = ops.flash_attention(q, k, v, causal=case["causal"], **kw)
            out[("attention", n, name)] = got.numpy()
    return out


def _train_setup(inputs: dict, arch: str):
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import convert
    from repro_torch.training.optimizer import AdamW

    cfg = reduced_config(get_config(arch))
    params = convert.from_jax_params(cfg, inputs["params"][arch], device="cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in inputs["batches"][arch]]
    return cfg, params, batches, AdamW(**inputs["adamw"])


def case_train(rank: int, world: int, inputs: dict) -> dict:
    """The data-parallel step on every arch of ``inputs["params"]`` (its
    losses, parameters and gathered moments after each batch), and the
    ZeRO-1 update against the unsharded one on given gradients."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import convert
    from repro_torch.training.fault import adam_to_jax
    from repro_torch.training.optimizer import AdamState
    from repro_torch.training.train_step import make_sharded_train_step
    from repro_torch.training.tree import tree_leaves, tree_map

    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    out = {}
    for arch in inputs["params"]:
        cfg, params, batches, opt = _train_setup(inputs, arch)
        step = make_sharded_train_step(cfg, opt, mesh)
        state = step.init(params)
        metrics = []
        for b in batches:
            params, state, m = step(params, state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out[arch] = dict(metrics=metrics, params=convert.to_jax_params(cfg, params),
                         opt=adam_to_jax(cfg, step.gather_state(state)),
                         local_m=_np(state.m))

    # ZeRO-1 on the same full gradients, moments and parameters as the
    # unsharded update
    cfg, params, _, opt = _train_setup(inputs, inputs["zero1_arch"])
    step = make_sharded_train_step(cfg, opt, mesh)
    gen = torch.Generator().manual_seed(5)

    def draw(t):
        return torch.randn(t.shape, generator=gen, dtype=torch.float32)

    grads = tree_map(draw, params)
    full = AdamState(step=torch.tensor(3, dtype=torch.int32), m=tree_map(draw, params),
                     v=tree_map(lambda t: draw(t).square(), params))
    want_p, want_s = opt.update(grads, full, params)
    got_p, got_s = opt.update_zero1(grads, step.shard_state(full), params, step.zero)
    gathered = step.gather_state(got_s)
    leaves = lambda *trees: [t for tree in trees for t in tree_leaves(tree)]  # noqa: E731
    out["zero1"] = dict(
        equal=[torch.equal(a, b) for a, b in zip(leaves(got_p, gathered.m, gathered.v),
                                                 leaves(want_p, want_s.m, want_s.v))],
        sliced=sum(a.shape != b.shape for a, b in zip(leaves(got_s.m), leaves(want_s.m))),
        local_equal=all(torch.equal(a, b) for a, b in zip(
            leaves(got_s.m), leaves(step.zero.shard(want_s.m)))),
        step=int(got_s.step))
    return out


def case_checkpoint(rank: int, world: int, inputs: dict) -> dict:
    """``ResilientLoop`` over the data-parallel step: resume a checkpoint
    another data size wrote (its moments re-sliced), train on and write
    one; and a preempted loop resuming bit for bit."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import convert
    from repro_torch.training.fault import LoopConfig, Preempted, ResilientLoop, adam_to_jax
    from repro_torch.training.train_step import make_sharded_train_step
    from repro_torch.training.tree import tree_leaves

    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    arch = inputs["arch"]
    cfg, params0, batches, opt = _train_setup(inputs, arch)
    step = make_sharded_train_step(cfg, opt, mesh)
    workdir = pathlib.Path(inputs["dir"])

    def loop(path, total, **kw):
        return ResilientLoop(step, lambda i: batches[i],
                             LoopConfig(total_steps=total, ckpt_every=2, ckpt_dir=str(path)),
                             model_cfg=cfg, **kw)

    out = {}
    restored = loop(workdir / "elastic", inputs["resume_at"]).run(params0, step.init(params0))
    out["restored_m"] = _np(restored["opt_state"].m)
    after = loop(workdir / "elastic", len(batches)).run(params0, step.init(params0))
    out["after"] = dict(params=convert.to_jax_params(cfg, after["params"]),
                        opt=adam_to_jax(cfg, step.gather_state(after["opt_state"])),
                        loss=float(after["metrics"]["loss"]))

    def bomb(i):
        if i == 3:
            raise Preempted("simulated preemption")

    whole = loop(workdir / "whole", len(batches)).run(params0, step.init(params0))
    cut = loop(workdir / "preempted", len(batches), failure_hook=bomb)
    try:
        cut.run(params0, step.init(params0))
        out["preempted"] = False
    except Preempted:
        out["preempted"] = True
        cut.ckpt.wait()
    resumed = loop(workdir / "preempted", len(batches)).run(params0, step.init(params0))
    out["resume_equal"] = [torch.equal(a, b) for a, b in zip(
        tree_leaves((whole["params"], whole["opt_state"])),
        tree_leaves((resumed["params"], resumed["opt_state"])))]
    return out


def case_kv_shard_model(rank: int, world: int, inputs: dict) -> dict:
    """The models' KV-length-sharded prefill and greedy decode on groups of
    2 and 4 ranks (every rank holding its rows of each cache through
    ``lm.shard_state``): each scenario of ``inputs["scenarios"]``' logits
    per step, its tokens, and whether it took the sharded route."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import convert, lm

    groups = {n: dist.new_group(list(range(n))) for n in (2, 4)}
    gathers = []
    all_gather = dist.all_gather

    def counted(*args, **kw):  # the ring's unsharded route gathers its shards
        gathers.append(1)
        return all_gather(*args, **kw)

    dist.all_gather = counted
    out = {}
    for name, sc in inputs["scenarios"].items():
        cfg = reduced_config(get_config(sc["arch"]))
        params = convert.from_jax_params(cfg, inputs["params"][sc["arch"]], device="cpu")
        for n in sc["ranks"]:
            if rank >= n:
                continue
            full = lm.init_state(cfg, sc["batch"], sc["max_len"], device="cpu")
            state = lm.shard_state(full, groups[n])
            group = None if state is None else groups[n]
            state = full if state is None else state
            logits = []
            gathers.clear()
            with torch.inference_mode():
                for part in sc["prompts"]:
                    lg, state = lm.prefill(params, cfg, torch.from_numpy(part), state,
                                           kv_group=group)
                    logits.append(lg.numpy())
                tok = lg.argmax(-1)[:, None].to(torch.int32)
                tokens = [tok.numpy()]
                for _ in range(sc["steps"]):
                    lg, state = lm.decode(params, cfg, tok, state, kv_group=group)
                    logits.append(lg.numpy())
                    tok = lg.argmax(-1)[:, None].to(torch.int32)
                    tokens.append(tok.numpy())
            out[(name, n)] = dict(logits=logits, tokens=tokens, sharded=group is not None,
                                  gathers=len(gathers))
    dist.all_gather = all_gather
    return out


def case_dryrun_collectives(rank: int, world: int, inputs: dict) -> dict:
    """The bytes the real steps' collectives move, counted by wrapping
    ``dist.all_reduce``, ``dist.all_gather`` and the functional all-gathers
    (each call's output bytes): a data-parallel train step on a (data 2,
    model 1) mesh, and a KV-length-sharded decode on a (data 1, model 2)
    mesh."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import make_sharded_train_step

    seen = {}
    wrapped = {}

    def count(kind, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            ts = [args[0]] if fn is wrapped["all_reduce"] else (
                args[0] if fn is wrapped["all_gather"] else [out])
            seen[kind] = seen.get(kind, 0) + sum(t.numel() * t.element_size() for t in ts)
            return out
        return call

    def wrap():
        wrapped.update(all_reduce=dist.all_reduce, all_gather=dist.all_gather,
                       all_gather_single=funcol.all_gather_single,
                       all_gather_tensor=funcol.all_gather_tensor)
        dist.all_reduce = count("all-reduce", dist.all_reduce)
        dist.all_gather = count("all-gather", dist.all_gather)
        funcol.all_gather_single = count("all-gather", funcol.all_gather_single)
        funcol.all_gather_tensor = count("all-gather", funcol.all_gather_tensor)

    def unwrap():
        for name in ("all_reduce", "all_gather"):
            setattr(dist, name, wrapped[name])
        funcol.all_gather_single = wrapped["all_gather_single"]
        funcol.all_gather_tensor = wrapped["all_gather_tensor"]

    out = {}
    cfg = reduced_config(get_config(inputs["train_arch"]))
    params = lm.init(cfg, seed=0, device="cpu")
    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    step = make_sharded_train_step(cfg, AdamW(lr=1e-4), mesh)
    state = step.init(params)
    batch = {k: torch.from_numpy(v) for k, v in inputs["train_batch"].items()}
    wrap()
    try:
        step(params, state, batch)
    finally:
        unwrap()
    out["train"], seen = dict(seen), {}

    cfg = reduced_config(get_config(inputs["decode_arch"]))
    params = lm.init(cfg, seed=0, device="cpu")
    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
    group = mesh.get_group("model")
    full = lm.init_state(cfg, 1, inputs["decode_len"], device="cpu")
    local = lm.shard_state(full, group)
    wrap()
    try:
        with torch.inference_mode():
            lm.decode(params, cfg, torch.zeros((1, 1), dtype=torch.int32), local, kv_group=group)
    finally:
        unwrap()
    out["decode"] = dict(seen)
    return out


def _mesh(dims):
    """A DeviceMesh of ``dims`` ((pod,) data, model) on the gloo group."""
    from torch.distributed.device_mesh import init_device_mesh

    names = ("pod", "data", "model")[-len(dims):]
    return init_device_mesh("cpu", tuple(dims), mesh_dim_names=names)


def _specs_np(tree):
    """A spec tree's leaves as tuples (pickled by value)."""
    from repro_torch.training.tree import tree_leaves

    return [tuple(s) for s in tree_leaves(tree)]


def case_tensor_parallel(rank: int, world: int, inputs: dict) -> dict:
    """The step over (pod, data, model) meshes (``inputs["runs"]``: a name,
    the arch, the ``n_heads`` override, the mesh dims): its losses, the
    gathered parameters, this rank's shards and the specs; ``ResilientLoop``
    over the runs of ``inputs["loop_runs"]`` (``_tp_loops``); and the
    vocab-sharded ``nll_sums`` on model groups of 2 and 4 ranks."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import convert, lm
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import make_sharded_train_step

    out = {}
    for name, arch, heads, dims in inputs["runs"]:
        cfg = reduced_config(get_config(arch))
        if heads:
            cfg = dataclasses.replace(cfg, n_heads=heads)
        full = convert.from_jax_params(cfg, inputs["params"][name], device="cpu")
        mesh = _mesh(dims)
        step = make_sharded_train_step(cfg, AdamW(**inputs["adamw"]), mesh)
        params = step.shard_params(full)
        state = step.init(params)
        losses = []
        for b in inputs["batches"][name]:
            params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        out[name] = dict(losses=losses, local=_np(params), specs=_specs_np(step.param_specs),
                         params=convert.to_jax_params(cfg, step.gather_params(params)),
                         model_rank=dist.get_rank(mesh.get_group("model")))
        if name in inputs["loop_runs"]:
            batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                       for b in inputs["batches"][name]]
            out[("loop", name)] = _tp_loops(step, cfg, full, batches, params,
                                            pathlib.Path(inputs["dir"]) / name.replace("/", "_"))

    logits = torch.from_numpy(inputs["logits"])
    labels = torch.from_numpy(inputs["labels"])
    mask = torch.from_numpy(inputs["mask"])
    for n in (2, 4):
        group = dist.new_group(list(range(n)))
        if rank >= n:
            continue
        cols = logits.shape[-1] // n
        part = logits[..., rank * cols:(rank + 1) * cols]
        for masked in (False, True):
            total, count = lm.nll_sums(part, labels, mask if masked else None, model_group=group)
            out[("nll", n, masked)] = (float(total), float(count))
    return out


def _tp_loops(step, cfg, full, batches, after, workdir) -> dict:
    """``ResilientLoop`` over a model-axis ``step`` from the whole tree
    ``full``, a checkpoint after every step: the loop run whole (its
    shards against ``after``, the step's own run), and preempted before
    its last step then resumed (shards gathered, written in the reference's
    layout by global rank 0, re-sharded on restore) against the whole run,
    bit for bit on this rank; and the state's and parameters' shards
    through ``gather_*`` then ``shard_*``."""
    import torch

    from repro_torch.training.fault import LoopConfig, Preempted, ResilientLoop
    from repro_torch.training.tree import tree_leaves

    def loop(path, **kw):
        return ResilientLoop(step, lambda i: batches[i],
                             LoopConfig(total_steps=len(batches), ckpt_every=1,
                                        ckpt_dir=str(workdir / path)), model_cfg=cfg, **kw)

    def equal(a, b):
        return [torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b))]

    def bomb(i):
        if i == len(batches) - 1:
            raise Preempted("simulated preemption")

    params = step.shard_params(full)
    whole = loop("whole").run(params, step.init(params))
    cut = loop("preempted", failure_hook=bomb)
    try:
        cut.run(params, step.init(params))
        preempted = False
    except Preempted:
        preempted = True
        cut.ckpt.wait()
    resumed = loop("preempted").run(params, step.init(params))
    state = whole["opt_state"]
    return dict(
        preempted=preempted,
        whole_is_the_step=equal(whole["params"], after),
        resume_equal=equal((whole["params"], state), (resumed["params"], resumed["opt_state"])),
        state_round_trip=equal(step.shard_state(step.gather_state(state)), state),
        params_round_trip=equal(step.shard_params(step.gather_params(whole["params"])),
                                whole["params"]))


def case_dryrun_tp(rank: int, world: int, inputs: dict) -> dict:
    """The collectives the real tensor-parallel and pod-axis steps call,
    by op and by group (``dist.all_reduce`` and ``dist.all_gather``
    wrapped: each call's output bytes, under the group it received), and
    rank 0's ``FlopCounterMode`` count of its step, on each mesh of
    ``inputs["meshes"]``."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import make_sharded_train_step

    cfg = reduced_config(get_config(inputs["arch"]))
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    out = {}
    for dims in inputs["meshes"]:
        mesh = _mesh(dims)
        names = {}
        for axis in ("model", "pod"):
            if axis in mesh.mesh_dim_names and mesh.shape[mesh.mesh_dim_names.index(axis)] > 1:
                names[id(mesh.get_group(axis))] = axis
        by_op, by_group = {}, {}
        originals = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

        def counted(name, kind):
            def call(*args, **kw):
                result = originals[name](*args, **kw)
                ts = [args[0]] if name == "all_reduce" else args[0]
                nbytes = sum(t.numel() * t.element_size() for t in ts)
                by_op[kind] = by_op.get(kind, 0) + nbytes
                axis = names.get(id(kw.get("group")))
                if axis is not None:
                    by_group[axis] = by_group.get(axis, 0) + nbytes
                return result
            return call

        step = make_sharded_train_step(cfg, AdamW(lr=1e-4), mesh)
        params = step.shard_params(lm.init(cfg, seed=0, device="cpu"))
        state = step.init(params)
        flops = FlopCounterMode(display=False)
        dist.all_reduce = counted("all_reduce", "all-reduce")
        dist.all_gather = counted("all_gather", "all-gather")
        try:
            with flops:
                step(params, state, batch)
        finally:
            dist.all_reduce, dist.all_gather = originals["all_reduce"], originals["all_gather"]
        out[tuple(dims)] = dict(by_op=by_op, by_group=by_group, flops=flops.get_total_flops())
    return out


CASES = {"collectives": case_collectives, "train": case_train, "checkpoint": case_checkpoint,
         "kv_shard_model": case_kv_shard_model, "dryrun_collectives": case_dryrun_collectives,
         "tensor_parallel": case_tensor_parallel, "dryrun_tp": case_dryrun_tp}


def main(argv) -> None:
    case, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), pathlib.Path(argv[3])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(workdir / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(str(workdir / "store"), world),
                            rank=rank, world_size=world)
    try:
        out = CASES[case](rank, world, inputs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(workdir / f"out_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
