"""Which collectives a gloo group runs on CUDA tensors: two, then four
processes of this script on one card (two, with and without
``GLOO_SOCKET_IFNAME=lo``, then four), each printing every collective's
outcome and wall (all-reduce SUM and MAX, ``all_gather``,
``all_gather_into_tensor`` and a 2 x 2,048 x 896 all-reduce, in f32 and
bf16; DTensor's ``distribute_tensor`` and ``full_tensor`` on a ``(1,
world)`` mesh).  A rank that crashes shows in the exit codes the parent
prints.

    python3 scripts/gloo_cuda_probe.py
"""
import os, sys, subprocess, tempfile, time, traceback, json


def rank_main(rank, world, store_dir):
    import faulthandler; faulthandler.enable()
    print("rank", rank, "start", os.environ.get("GLOO_SOCKET_IFNAME"), flush=True)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, Replicate, distribute_tensor
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(store_dir, "s"), world),
                            rank=rank, world_size=world)
    print("rank", rank, "init ok", flush=True)
    c = torch.ones(3); dist.all_reduce(c); print("rank", rank, "cpu all_reduce", c.tolist(), flush=True)
    res = {}
    def probe(name, fn):
        try:
            t0 = time.perf_counter()
            ok = fn()
            torch.cuda.synchronize()
            res[name] = f"ok {ok} {1e3*(time.perf_counter()-t0):.2f} ms"
            print("rank", rank, name, res[name], flush=True)
        except Exception as e:
            res[name] = f"FAIL {type(e).__name__}: {str(e)[:300]}"
    dev = "cuda"
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((4, 8), float(rank + 1), device=dev, dtype=dt)
        def ar_sum(x=x):
            y = x.clone(); dist.all_reduce(y); return float(y[0, 0]) == sum(range(1, world + 1))
        def ar_max(x=x):
            y = x.clone(); dist.all_reduce(y, op=dist.ReduceOp.MAX); return float(y[0, 0]) == world
        def ag_list(x=x):
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x.contiguous()); return [float(p[0, 0]) for p in parts]
        def ag_tensor(x=x):
            out = torch.empty((4 * world, 8), device=dev, dtype=dt)
            dist.all_gather_into_tensor(out, x); return float(out[-1, 0])
        def big(x=x):
            y = torch.randn(2, 2048, 896, device=dev).to(dt); dist.all_reduce(y); return tuple(y.shape)
        for n, f in (("all_reduce_sum", ar_sum), ("all_reduce_max", ar_max), ("all_gather", ag_list),
                     ("all_gather_into_tensor", ag_tensor), ("all_reduce_2x2048x896", big)):
            probe(f"{n}[{dt}]", f)
    try:
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        res["mesh"] = str(mesh)
        full = torch.arange(world * 6, dtype=torch.float32, device=dev).reshape(world * 2, 3)
        def dt_shard():
            loc = distribute_tensor(full, mesh["model"], (Shard(0),), src_data_rank=None).to_local()
            return tuple(loc.shape)
        def dt_gather():
            loc = full[rank * 2:(rank + 1) * 2]
            g = DTensor.from_local(loc, mesh["model"], (Shard(0),), run_check=False).full_tensor()
            return bool(torch.equal(g, full))
        probe("dtensor_shard", dt_shard)
        probe("dtensor_full_tensor", dt_gather)
        probe("group_all_reduce", lambda: dist.all_reduce(torch.ones(3, device=dev), group=mesh.get_group("model")) is None)
    except Exception as e:
        res["mesh"] = f"FAIL {type(e).__name__}: {e}"
    res["mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    dist.barrier()
    dist.destroy_process_group()
    print("RANK", rank, json.dumps(res), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    import torch
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    for world, env in ((2, {}), (2, {"GLOO_SOCKET_IFNAME": "lo"}), (4, {"GLOO_SOCKET_IFNAME": "lo"})):
        d = tempfile.mkdtemp()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), d], env=dict(os.environ, **env)) for r in range(world)]
        rcs = [p.wait(timeout=300) for p in procs]
        print(f"world {world}: rcs {rcs} wall {time.perf_counter()-t0:.1f} s", flush=True)
