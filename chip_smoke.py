"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then:

1. serve phase — full-width, full-depth llama-7b in bf16 (random weights
   from a seeded generator) behind the port's ``ServingEngine``: the default
   ``EngineConfig`` but ``max_slots=4, max_len=4096``, H100 ``PerfModel`` and
   prices, ``CostAwarePlanner``.  Two ~2,000-token contexts, three requests
   each, arrive in three waves: the first recomputes and writes back, the
   second loads, the third loads one context and partially reuses a variant
   of the other.  The launch counters are zeroed just before this run and
   read just after it.  The same traffic is then served with reuse off, and
   each reused request's first-token logits are held against it.
2. kernel phase — each kernel is called on the inputs one of its main-path
   launches received (recorded in phase 1, first layer) and held against its
   plain PyTorch version: in bf16 at atol 1e-2, and cast to f32 (TF32 off)
   at the CPU tests' atol 2e-5.  Times come from CUDA events after warm-up,
   beside the plain version's, one PyTorch library call's
   (``scaled_dot_product_attention`` with an explicit boolean mask, timed
   here only) and the card's bound for the same work.

Any failed check raises, so the script exits non-zero.  The line before the
last is ``{"kernels": [...]}``; the last is the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script runs on the GPU only")

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import packed_prefill as pk  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CostAwarePlanner,
    EngineConfig,
    Request,
    ServingEngine,
)
from repro_torch.serving import events as ev  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the peak
# rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_ATOL = 1e-2
F32_ATOL = 2e-5
# Reused vs recomputed first-token logits, bf16 model: the stored rows are
# the same bf16 values either way, but the packed launches differ in length,
# so the matmuls round differently and the difference compounds over 32
# layers.  Logits of this random-weight model are O(1) (unit-variance final
# norm into a 1/sqrt(d) head); 0.25 is a quarter of that scale.
LOGIT_ATOL = 0.25
SEED = 0

SERVE = dict(max_slots=4, max_len=4096)
CTX_LEN, PROMPT_LEN, NEW_TOKENS = 2000, 32, 16


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# Traffic
# --------------------------------------------------------------------------- #
def traffic(vocab: int):
    """Six requests over two ~2,000-token contexts A and B, in three waves
    one modelled second apart (each wave finishes well inside a second on
    the H100 model, so later waves find the earlier contexts stored):
    wave 0 recomputes A and B and writes them back, wave 1 loads them, wave
    2 loads A and reuses the first 1,600 tokens of a variant of B."""
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, vocab, CTX_LEN).tolist()
    b = rng.integers(0, vocab, CTX_LEN).tolist()
    b_variant = b[:1600] + rng.integers(0, vocab, 416).tolist()
    contexts = [a, b, a, b, a, b_variant]
    return [
        dict(req_id=i, context_tokens=ctx,
             prompt_tokens=rng.integers(0, vocab, PROMPT_LEN).tolist(),
             max_new_tokens=NEW_TOKENS, arrival_s=float(i // 2), expected_reuses=3)
        for i, ctx in enumerate(contexts)
    ]


class Recorder:
    """Wraps the model's attention entry points, the engine's model calls and
    its host-side storage steps to record what the main path did: the first
    layer's inputs of one launch of each kernel, every logits tensor, and
    the wall time of each part of a step (each timed part synchronises the
    card before and after, so device work is charged to the part that
    queued it)."""

    def __init__(self, eng: ServingEngine, n_layers: int):
        self.eng, self.n_layers = eng, n_layers
        self.packed_inputs, self.decode_inputs = None, None
        self.first_logits = {}
        self.spent = {}
        self._calls = {"packed": 0, "decode": 0}
        self._patched = [
            (ops, "packed_attention", self._packed),
            (ops, "decode_attention", self._decode),
            (eng, "api", eng.api._replace(prefill_packed=self._prefill, decode=self._step)),
        ]
        for name in ("fetch", "put"):
            self._patched.append((eng.store, name, self._timed(f"store_{name}",
                                                               getattr(eng.store, name))))
        for name in ("build_packed_caches", "artifact_to_host", "insert_slot"):
            self._patched.append((paged, name, self._timed(name, getattr(paged, name))))
        self._orig = [(obj, name, getattr(obj, name)) for obj, name, _ in self._patched]
        self._orig_api = eng.api
        for obj, name, fn in self._patched:
            setattr(obj, name, fn)

    def close(self):
        for obj, name, fn in self._orig:
            setattr(obj, name, fn)

    def _timed(self, part, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.spent[part] = self.spent.get(part, 0.0) + time.perf_counter() - t0
            return out
        return run

    def _keep(self, args, kw):
        return [a.clone() for a in args], {
            k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()
        }

    def _packed(self, *args, **kw):
        # the first wave's first layer: the largest packed launch of the run
        if self._calls["packed"] == 0:
            self.packed_inputs = self._keep(args, kw)
        self._calls["packed"] += 1
        return self._orig[0][2](*args, **kw)

    def _decode(self, *args, **kw):
        # the first layer of the first wave's last decode step
        if self._calls["decode"] == self.n_layers * (NEW_TOKENS - 2):
            self.decode_inputs = self._keep(args, kw)
        self._calls["decode"] += 1
        return self._orig[1][2](*args, **kw)

    def _prefill(self, *args, **kw):
        logits, caches = self._timed("model", self._orig_api.prefill_packed)(*args, **kw)
        assert torch.isfinite(logits).all(), "non-finite prefill logits"
        self.batch_logits = logits.float().cpu()
        return logits, caches

    def _step(self, *args, **kw):
        logits, state = self._timed("model", self._orig_api.decode)(*args, **kw)
        assert torch.isfinite(logits).all(), "non-finite decode logits"
        return logits, state


def serve(cfg, params, *, reuse: bool):
    """Serve the traffic once; returns (engine, records by id, recorder,
    per-step rows (kind, wall_s, modelled load_s, modelled prefill or decode
    s, q_len, kv_len, wall s by part), write-back count)."""
    eng = ServingEngine(
        cfg, params, engine_cfg=EngineConfig(reuse_enabled=reuse, **SERVE),
        planner=CostAwarePlanner(), device="cuda",
    )
    for r in traffic(cfg.vocab):
        eng.submit(Request(**r))
    rec = Recorder(eng, cfg.n_layers)
    steps = []
    first_logits = {}
    writebacks = 0
    try:
        while not eng.idle:
            busy0 = eng.admission_busy_s + eng.decode_busy_s
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events = eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            modelled = eng.admission_busy_s + eng.decode_busy_s - busy0
            writebacks += sum(isinstance(e, ev.StoreWriteBack) for e in events)
            batch = [e for e in events if isinstance(e, ev.BatchAdmitted)]
            if batch:
                prefill_s = next(e.prefill_s for e in events if isinstance(e, ev.PrefillDone))
                steps.append(("prefill", wall, modelled - prefill_s, prefill_s,
                              batch[0].q_len, batch[0].kv_len, dict(rec.spent)))
                for i, rid in enumerate(batch[0].req_ids):
                    first_logits[rid] = rec.batch_logits[i]
            elif any(isinstance(e, ev.TokenEmitted) for e in events):
                steps.append(("decode", wall, 0.0, modelled, 0, 0, dict(rec.spent)))
            rec.spent.clear()
    finally:
        rec.close()
    rec.first_logits = first_logits
    return eng, {r.req_id: r for r in eng.records}, rec, steps, writebacks


# --------------------------------------------------------------------------- #
# Timing and bounds
# --------------------------------------------------------------------------- #
def time_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_ms(bytes_: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def packed_mask(kw):
    qp, kp = kw["q_pos"][0].long(), kw["kv_pos"][0].long()
    qs, ks = kw["q_seg"][0].long(), kw["kv_seg"][0].long()
    return (kp[None] >= 0) & (qs[:, None] == ks[None]) & (kp[None] <= qp[:, None])


def decode_mask(kw):
    qp, kp = kw["q_pos"].long(), kw["kv_pos"].long()  # [B, 1], [B, L]
    return (kp >= 0) & (kp <= qp)


def check_packed(inputs, launches):
    (q, k, v), kw = inputs
    H, hd = q.shape[2], q.shape[3]
    mask = packed_mask(kw)
    pairs = int(mask.sum())
    rows = {}
    for dtype, atol in ((torch.bfloat16, BF16_ATOL), (torch.float32, F32_ATOL)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        got = pk.packed_flash_attention(qq, kk, vv, **kw)
        want = pk.packed_flash_attention_plain(qq, kk, vv, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol, f"packed_flash_attention {dtype}: max err {err} > {atol}"
        ms = time_ms(lambda: pk.packed_flash_attention(qq, kk, vv, **kw))
        plain = time_ms(lambda: pk.packed_flash_attention_plain(qq, kk, vv, **kw), reps=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (qq, kk, vv))
        m4 = mask[None, None]
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m4))
        index = [kw[n] for n in ("q_pos", "kv_pos", "q_seg", "kv_seg")]
        b, by = bound_ms(nbytes(qq, kk, vv, got, *index), 4.0 * hd * H * pairs, dtype)
        rows[dtype] = dict(err=err, ms=ms, plain=plain, lib=lib, bound=b, by=by)
        log(f"kernel packed_flash_attention {str(dtype)[6:]} q{tuple(q.shape)} "
            f"kv{tuple(k.shape)} kept_pairs/head={pairs}: max_err={err:.3e} "
            f"ms={ms:.4f} plain_ms={plain:.4f} sdpa_ms={lib:.4f} bound_ms={b:.4f} ({by})")
    r = rows[torch.bfloat16]
    return dict(name="packed_flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/packed_prefill.cu",
                replaces="src/repro/kernels/packed_prefill.py:99", launches=launches,
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain"],
                bound_ms=r["bound"], bound_by=r["by"], library_ms=r["lib"])


def check_decode(inputs, launches):
    (q, k, v), kw = inputs
    B, _, H, hd = q.shape
    KV = k.shape[2]
    mask = decode_mask(kw)  # [B, L]
    kept = int(mask.sum())
    rows = {}
    for dtype, atol in ((torch.bfloat16, BF16_ATOL), (torch.float32, F32_ATOL)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        got = dk.decode_attention(qq, kk, vv, **kw)
        want = dk.decode_attention_plain(qq, kk, vv, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol, f"decode_attention {dtype}: max err {err} > {atol}"
        ms = time_ms(lambda: dk.decode_attention(qq, kk, vv, **kw), reps=20)
        plain = time_ms(lambda: dk.decode_attention_plain(qq, kk, vv, **kw), reps=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (qq, kk, vv))
        m4 = mask[:, None, None, :]
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m4), reps=20)
        # bytes the function needs: q, the kept K/V rows, every position, out
        kv_bytes = 2 * kept * KV * hd * qq.element_size()
        b, by = bound_ms(nbytes(qq, got, kw["q_pos"], kw["kv_pos"]) + kv_bytes,
                         4.0 * hd * (H // KV) * KV * kept, dtype)
        rows[dtype] = dict(err=err, ms=ms, plain=plain, lib=lib, bound=b, by=by)
        log(f"kernel decode_attention {str(dtype)[6:]} q{tuple(q.shape)} "
            f"cache{tuple(k.shape)} kept_rows={kept}: max_err={err:.3e} ms={ms:.4f} "
            f"plain_ms={plain:.4f} sdpa_ms={lib:.4f} bound_ms={b:.4f} ({by})")
    r = rows[torch.bfloat16]
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:83", launches=launches,
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain"],
                bound_ms=r["bound"], bound_by=r["by"], library_ms=r["lib"])


# --------------------------------------------------------------------------- #
def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; kernels built in "
        f"{time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- serve phase ------------------------------------------------------
    cfg = get_config("llama-7b")
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"llama-7b bf16: {sum(p.numel() for p in _leaves(params)) / 1e9:.2f} B params "
        f"drawn in {time.perf_counter() - t0:.1f} s")

    pk.packed_flash_attention.launches = 0
    dk.decode_attention.launches = 0
    eng, recs, rec, steps, writebacks = serve(cfg, params, reuse=True)
    launches = {"packed": pk.packed_flash_attention.launches,
                "decode": dk.decode_attention.launches}
    n_decode = eng.decode_stats()["decode_steps"]
    log(f"main path launches: packed_flash_attention={launches['packed']} "
        f"decode_attention={launches['decode']} (decode steps {n_decode}, "
        f"packed batches {eng.batches})")
    for kind, wall, load_s, modelled, q_len, kv_len, parts in steps:
        parts = " ".join(f"{k}={1e3 * v:.2f}" for k, v in sorted(parts.items()))
        if kind == "prefill":
            log(f"step prefill q_len={q_len} kv_len={kv_len}: wall_ms={1e3 * wall:.2f} "
                f"modelled_prefill_ms={1e3 * modelled:.3f} modelled_load_ms={1e3 * load_s:.3f} "
                f"| wall ms by part: {parts}")
        else:
            log(f"step decode: wall_ms={1e3 * wall:.2f} modelled_ms={1e3 * modelled:.3f} "
                f"| {parts}")
    actions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
    log(f"actions (action, matched tokens): {actions}")
    log(f"write-backs: {writebacks}, store entries: {len(eng.store.entries)}")
    assert len(recs) == 6 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
    assert any(a in ("load", "partial") for a, _ in actions.values()), actions
    assert any(a == "recompute" for a, _ in actions.values()) and writebacks >= 1, (
        actions, writebacks)
    assert launches["packed"] > 0 and launches["decode"] >= n_decode > 0, launches
    first_logits = rec.first_logits
    packed_inputs, decode_inputs = rec.packed_inputs, rec.decode_inputs
    summary = eng.summary().as_dict()
    log(f"summary: {json.dumps(summary)}")
    del eng, rec
    torch.cuda.empty_cache()

    base, base_recs, base_rec, _, _ = serve(cfg, params, reuse=False)
    reused = [i for i, (a, _) in actions.items() if a in ("load", "partial")]
    agree = total = 0
    for i in reused:
        diff = (first_logits[i] - base_rec.first_logits[i]).abs().max().item()
        same = sum(x == y for x, y in zip(recs[i].tokens, base_recs[i].tokens))
        agree, total = agree + same, total + NEW_TOKENS
        log(f"request {i} ({actions[i][0]}): first-token logits max|reuse - recompute| "
            f"= {diff:.4f}, tokens agreeing {same}/{NEW_TOKENS}")
        assert diff <= LOGIT_ATOL, (i, diff)
    log(f"reuse vs recompute token agreement: {agree}/{total}")
    del base, base_rec, params
    torch.cuda.empty_cache()

    # ---- kernel phase -----------------------------------------------------
    kernels = [check_packed(packed_inputs, launches["packed"]),
               check_decode(decode_inputs, launches["decode"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
