"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from ``src/repro_torch/kernels/csrc``
with nvcc (one nvcc per source, all started together), then drives three
paths of the port, each with every launch counter zeroed just before it and
read just after it:

1. dense serve phase — full-width, full-depth llama-7b in bf16 (random
   weights from a seeded generator) behind the port's ``ServingEngine``: the
   default ``EngineConfig`` but ``max_slots=4, max_len=4096``, H100
   ``PerfModel`` and prices, ``CostAwarePlanner``.  Two ~2,000-token
   contexts, three requests each, arrive in three waves: the first
   recomputes and writes back, the second loads, the third loads one context
   and partially reuses a variant of the other.  The same traffic is then
   served with reuse off, and each reused request's first-token logits are
   held against it.
2. paged serve phase — the same traffic through ``EngineConfig(
   paged_decode=True, kv_block=128)``, after the dense engines are dropped:
   the same actions, first-token logits and every decode step's logits as
   the dense run, bit for bit, 32 paged-decode launches per decode step and
   no dense-decode launch.
3. per-request prefill phase — ``ModelApi.prefill`` of each request's
   context and prompt into a fresh batch-1 state (32 flash launches per
   call), held against the engine's first-token logits of the recompute
   run; then one load request's stored context inserted into a fresh slot
   and its prompt suffix-prefilled after it (twice), held against the reuse
   run.

Then the kernel phase: each kernel is called on the inputs one of its
launches on those paths received (first layer) and held against its plain
PyTorch version: in bf16 at atol 1e-2, and cast to f32 (TF32 off) at the
CPU tests' atol 2e-5.  Times come from CUDA events after warm-up, beside
the plain version's, one PyTorch library call's
(``scaled_dot_product_attention`` with an explicit boolean mask, timed here
only; for paged decode on rows gathered beforehand, the gather excluded)
and the card's bound for the same work.

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
from repro_torch.kernels import flash_prefill as fk  # noqa: E402
from repro_torch.kernels import packed_prefill as pk  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
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
# the launch counter of each kernel, by the name the JSON line gives it
COUNTERS = {"packed_flash_attention": pk.packed_flash_attention,
            "decode_attention": dk.decode_attention,
            "flash_attention": fk.flash_attention,
            "paged_decode_attention": pdk.paged_decode_attention}


def zero_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


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


def keep(args, kw):
    """Copies of a kernel call's arguments, kept for the kernel phase."""
    return [a.clone() for a in args], {
        k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()
    }


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
        self.step_logits = []  # every decode step's logits of the active slots
        self.spent = {}
        self._calls = {"packed": 0, "decode": 0}
        self._patched = [
            (ops, "packed_attention", self._packed),
            (ops, "decode_attention", self._decode),
            (ops, "paged_decode", self._paged),
            (eng, "api", eng.api._replace(prefill_packed=self._prefill, decode=self._step,
                                          decode_paged=self._step_paged)),
        ]
        for name in ("fetch", "put"):
            self._patched.append((eng.store, name, self._timed(f"store_{name}",
                                                               getattr(eng.store, name))))
        for name in ("build_packed_caches", "artifact_to_host", "insert_slot"):
            self._patched.append((paged, name, self._timed(name, getattr(paged, name))))
        if eng._paged_on:
            self._patched.append((eng, "_land_packed_in_pool", self._timed(
                "land_in_pool", eng._land_packed_in_pool)))
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

    def _packed(self, *args, **kw):
        # the first wave's first layer: the largest packed launch of the run
        if self._calls["packed"] == 0:
            self.packed_inputs = keep(args, kw)
        self._calls["packed"] += 1
        return self._orig[0][2](*args, **kw)

    def _decode(self, *args, **kw):
        return self._decoded(self._orig[1][2], args, kw)

    def _paged(self, *args, **kw):
        return self._decoded(self._orig[2][2], args, kw)

    def _decoded(self, fn, args, kw):
        # the first layer of the first wave's last decode step
        if self._calls["decode"] == self.n_layers * (NEW_TOKENS - 2):
            self.decode_inputs = keep(args, kw)
        self._calls["decode"] += 1
        return fn(*args, **kw)

    def _prefill(self, *args, **kw):
        logits, caches = self._timed("model", self._orig_api.prefill_packed)(*args, **kw)
        assert torch.isfinite(logits).all(), "non-finite prefill logits"
        self.batch_logits = logits.float().cpu()
        return logits, caches

    def _step(self, *args, **kw):
        return self._stepped(self._orig_api.decode, *args, **kw)

    def _step_paged(self, *args, **kw):
        return self._stepped(self._orig_api.decode_paged, *args, **kw)

    def _stepped(self, fn, *args, **kw):
        active = [s.index for s in self.eng.slots if s.active]
        logits, state = self._timed("model", fn)(*args, **kw)
        assert torch.isfinite(logits[active]).all(), "non-finite decode logits"
        self.step_logits.append((active, logits[active].float().cpu()))
        return logits, state


def serve(cfg, params, *, reuse: bool = True, **ec_kw):
    """Serve the traffic once; returns (engine, records by id, recorder,
    per-step rows (kind, wall_s, modelled load_s, modelled prefill or decode
    s, q_len, kv_len, wall s by part), write-back count)."""
    eng = ServingEngine(
        cfg, params, engine_cfg=EngineConfig(reuse_enabled=reuse, **SERVE, **ec_kw),
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


def check_kernel(name, source, replaces, launches, inputs, kernel, plain, *, mask4,
                 index, kv_rows, pairs, note, label="", reps=10, plain_reps=3,
                 sdpa_kv=lambda t: t, sdpa_note=""):
    """Hold one kernel against its plain version on the inputs one of its
    launches received, in bf16 at ``BF16_ATOL`` and cast to f32 at
    ``F32_ATOL``, and time it, its plain version and SDPA with the explicit
    boolean mask ``mask4`` (on ``sdpa_kv`` of the K/V operands).  The bound
    counts the bytes of q, the output, the ``index`` tensors and ``kv_rows``
    K/V rows, and 4·hd·H operations per kept (query, kv row) pair.  Returns
    the kernel's entry of the ``{"kernels": [...]}`` line, from the bf16 run."""
    (q, k, v), kw = inputs
    H, hd, KV = q.shape[2], q.shape[3], k.shape[-2]
    rows = {}
    for dtype, atol in ((torch.bfloat16, BF16_ATOL), (torch.float32, F32_ATOL)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        got = kernel(qq, kk, vv, **kw)
        want = plain(qq, kk, vv, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol, f"{name} {label} {dtype}: max err {err} > {atol}"
        ms = time_ms(lambda: kernel(qq, kk, vv, **kw), reps=reps)
        plain_ms = time_ms(lambda: plain(qq, kk, vv, **kw), reps=plain_reps)
        qt = qq.transpose(1, 2)
        kt, vt = (sdpa_kv(t).repeat_interleave(H // KV, -2).transpose(1, 2) for t in (kk, vv))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4), reps=reps)
        kv_bytes = 2 * kv_rows * KV * hd * qq.element_size()
        b, by = bound_ms(nbytes(qq, got, *index) + kv_bytes, 4.0 * hd * H * pairs, dtype)
        rows[dtype] = dict(err=err, ms=ms, plain=plain_ms, lib=lib, bound=b, by=by)
        log(f"kernel {name}{' ' + label if label else ''} {str(dtype)[6:]} "
            f"q{tuple(q.shape)} {note}: max_err={err:.3e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={lib:.4f}{sdpa_note} bound_ms={b:.4f} ({by})")
    r = rows[torch.bfloat16]
    return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                replaces=replaces, launches=launches, max_abs_err=r["err"], ms=r["ms"],
                plain_ms=r["plain"], bound_ms=r["bound"], bound_by=r["by"],
                library_ms=r["lib"])


def check_packed(inputs, launches):
    (q, k, _), kw = inputs
    qp, kp = kw["q_pos"][0].long(), kw["kv_pos"][0].long()
    qs, ks = kw["q_seg"][0].long(), kw["kv_seg"][0].long()
    mask = (kp[None] >= 0) & (qs[:, None] == ks[None]) & (kp[None] <= qp[:, None])
    pairs = int(mask.sum())
    # the packed kernel reads every K/V row of the buffer
    return check_kernel(
        "packed_flash_attention", "packed_prefill.cu",
        "src/repro/kernels/packed_prefill.py:99", launches, inputs,
        pk.packed_flash_attention, pk.packed_flash_attention_plain,
        mask4=mask[None, None], index=[kw[n] for n in ("q_pos", "kv_pos", "q_seg", "kv_seg")],
        kv_rows=k.shape[0] * k.shape[1], pairs=pairs,
        note=f"kv{tuple(k.shape)} kept_pairs/head={pairs}")


def check_decode(inputs, launches):
    (q, k, _), kw = inputs
    mask = (kw["kv_pos"].long() >= 0) & (kw["kv_pos"].long() <= kw["q_pos"].long())
    kept = int(mask.sum())  # [B, L] rows each sequence's query keeps
    return check_kernel(
        "decode_attention", "decode_attention.cu", "src/repro/kernels/decode_attention.py:83",
        launches, inputs, dk.decode_attention, dk.decode_attention_plain,
        mask4=mask[:, None, None, :], index=[kw["q_pos"], kw["kv_pos"]], kv_rows=kept,
        pairs=kept, note=f"cache{tuple(k.shape)} kept_rows={kept}", reps=20, plain_reps=5)


def check_flash(inputs, launches, label):
    (q, k, _), kw = inputs
    qp, kp = kw["q_pos"].long()[:, :, None], kw["kv_pos"].long()[:, None, :]
    mask = kp >= 0
    if kw.get("causal", True):
        mask = mask & (kp <= qp)
    if kw.get("window") is not None:
        mask = mask & (kp > qp - kw["window"])
    if kw.get("kv_valid") is not None:
        mask = mask & kw["kv_valid"][:, None, :]
    pairs = int(mask.sum())  # [B, Sq, Skv]; per head
    rows = int(mask.any(dim=1).sum())  # kv rows some query keeps
    return check_kernel(
        "flash_attention", "flash_prefill.cu", "src/repro/kernels/flash_prefill.py:91",
        launches, inputs, fk.flash_attention, fk.flash_attention_plain,
        mask4=mask[:, None], index=[kw["q_pos"], kw["kv_pos"]], kv_rows=rows, pairs=pairs,
        note=f"cache{tuple(k.shape)} kept_pairs/head={pairs} kept_rows={rows}", label=label)


def check_paged(inputs, launches):
    (q, k_pool, _), kw = inputs
    B = q.shape[0]
    table, block = kw["block_table"], kw["block"]
    L = table.shape[1] * block
    rows = (table.long()[:, :, None] * block
            + torch.arange(block, device=q.device)[None, None]).reshape(B, L)
    idx = torch.arange(L, device=q.device)[None]
    mask = idx <= kw["q_pos"]  # [B, L]: validity is positional
    if kw.get("window") is not None:
        mask = mask & (idx > kw["q_pos"] - kw["window"])
    kept = int(mask.sum())
    # SDPA runs on the rows gathered beforehand (the gather is not timed)
    return check_kernel(
        "paged_decode_attention", "paged_decode.cu", "src/repro/kernels/paged_decode.py:101",
        launches, inputs, pdk.paged_decode_attention, pdk.paged_decode_attention_plain,
        mask4=mask[:, None, None, :], index=[table, kw["q_pos"]], kv_rows=kept, pairs=kept,
        note=f"pool{tuple(k_pool.shape)} table{tuple(table.shape)} kept_rows={kept}",
        reps=20, plain_reps=5, sdpa_kv=lambda t: t[rows], sdpa_note=" (gather excluded)")


def log_steps(label, steps):
    for kind, wall, load_s, modelled, q_len, kv_len, parts in steps:
        parts = " ".join(f"{k}={1e3 * v:.2f}" for k, v in sorted(parts.items()))
        if kind == "prefill":
            log(f"{label} step prefill q_len={q_len} kv_len={kv_len}: "
                f"wall_ms={1e3 * wall:.2f} modelled_prefill_ms={1e3 * modelled:.3f} "
                f"modelled_load_ms={1e3 * load_s:.3f} | wall ms by part: {parts}")
        else:
            log(f"{label} step decode: wall_ms={1e3 * wall:.2f} "
                f"modelled_ms={1e3 * modelled:.3f} | {parts}")


def stored_artifact(eng, tokens):
    """The artifact the engine's store holds for ``tokens`` (a full match)."""
    match, entry = eng.store.lookup(tokens)
    assert entry is not None and match.matched_tokens == len(tokens), "context not stored"
    artifact, _ = eng.store.fetch(entry.entry_id, fraction=1.0)
    return artifact


def per_request_prefill(cfg, params, reqs, recompute_logits, load_req, artifact,
                        reuse_logits):
    """``ModelApi.prefill`` per request: each request's context + prompt into
    a fresh batch-1 state, held against the engine's recompute-run
    first-token logits; then ``load_req``'s stored context inserted into a
    fresh slot and its prompt prefilled after it (the ``_execute_load``
    shape), held against the reuse run.  Returns the first layer's flash
    inputs of the first full call and of the suffix call."""
    api = get_model(cfg)
    recorded = {}
    label = [None]  # the call whose first layer's inputs are kept
    flash = ops.flash_attention

    def record(*args, **kw):
        if label[0] is not None and label[0] not in recorded:
            recorded[label[0]] = keep(args, kw)
        return flash(*args, **kw)

    ops.flash_attention = record
    try:
        for r in reqs:
            label[0] = None if recorded else "full"
            before = fk.flash_attention.launches
            tokens = r["context_tokens"] + r["prompt_tokens"]
            state = api.init_state(cfg, 1, SERVE["max_len"], device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits, state = api.prefill(
                    params, cfg, torch.tensor([tokens], device="cuda"), state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = fk.flash_attention.launches - before
            diff = (logits[0].float().cpu() - recompute_logits[r["req_id"]]).abs().max().item()
            log(f"prefill request {r['req_id']} ({len(tokens)} tokens): wall_ms="
                f"{1e3 * wall:.2f} flash launches {n}, last-token logits "
                f"max|prefill - engine| = {diff:.4f}")
            assert n == cfg.n_layers, n
            assert int(state.pos[0]) == len(tokens)
            assert diff <= LOGIT_ATOL, (r["req_id"], diff)
            del state
        # the load path's shape: stored context rows, then the prompt alone
        # (twice: the first call of a new shape pays for its warm-up)
        prompt = load_req["prompt_tokens"]
        for attempt in range(2):
            label[0] = "suffix"
            before = fk.flash_attention.launches
            state = api.init_state(cfg, 1, SERVE["max_len"], device="cuda")
            paged.insert_slot(cfg, state, 0, artifact)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits, state = api.prefill(
                    params, cfg, torch.tensor([prompt], device="cuda"), state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = fk.flash_attention.launches - before
            diff = (logits[0].float().cpu()
                    - reuse_logits[load_req["req_id"]]).abs().max().item()
            log(f"suffix prefill request {load_req['req_id']} call {attempt} ({len(prompt)} "
                f"tokens after {len(load_req['context_tokens'])} stored): wall_ms="
                f"{1e3 * wall:.2f} flash launches {n}, last-token logits "
                f"max|prefill - engine (load)| = {diff:.4f}")
            assert n == cfg.n_layers, n
            assert diff <= LOGIT_ATOL, diff
            del state
    finally:
        ops.flash_attention = flash
    return recorded["full"], recorded["suffix"]


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

    # ---- dense serve phase ------------------------------------------------
    cfg = get_config("llama-7b")
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"llama-7b bf16: {sum(p.numel() for p in _leaves(params)) / 1e9:.2f} B params "
        f"drawn in {time.perf_counter() - t0:.1f} s")

    zero_counts()
    eng, recs, rec, steps, writebacks = serve(cfg, params)
    dense_counts = counts()
    n_decode = eng.decode_stats()["decode_steps"]
    log(f"dense serve launches: {dense_counts} (decode steps {n_decode}, "
        f"packed batches {eng.batches})")
    log_steps("dense", steps)
    actions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
    log(f"actions (action, matched tokens): {actions}")
    log(f"write-backs: {writebacks}, store entries: {len(eng.store.entries)}")
    assert len(recs) == 6 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
    assert any(a in ("load", "partial") for a, _ in actions.values()), actions
    assert any(a == "recompute" for a, _ in actions.values()) and writebacks >= 1, (
        actions, writebacks)
    assert dense_counts["packed_flash_attention"] > 0, dense_counts
    assert dense_counts["decode_attention"] == cfg.n_layers * n_decode > 0, dense_counts
    assert dense_counts["flash_attention"] == dense_counts["paged_decode_attention"] == 0
    first_logits, step_logits = rec.first_logits, rec.step_logits
    packed_inputs, decode_inputs = rec.packed_inputs, rec.decode_inputs
    reqs = traffic(cfg.vocab)
    load_req = next(reqs[i] for i, (a, m) in actions.items()
                    if a == "load" and m == len(reqs[i]["context_tokens"]))
    artifact = stored_artifact(eng, load_req["context_tokens"])
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
    recompute_logits = base_rec.first_logits
    del base, base_rec
    torch.cuda.empty_cache()

    # ---- paged serve phase ------------------------------------------------
    zero_counts()
    peng, precs, prec, psteps, _ = serve(cfg, params, paged_decode=True, kv_block=128)
    paged_counts = counts()
    pn_decode = peng.decode_stats()["decode_steps"]
    log(f"paged serve launches: {paged_counts} (decode steps {pn_decode})")
    log_steps("paged", psteps)
    log(f"paged decode_stats: {json.dumps(peng.decode_stats())}")
    pactions = {i: (r.action, r.matched_tokens) for i, r in sorted(precs.items())}
    assert pactions == actions, (pactions, actions)
    assert paged_counts["paged_decode_attention"] == cfg.n_layers * pn_decode > 0, paged_counts
    assert paged_counts["decode_attention"] == paged_counts["flash_attention"] == 0
    assert paged_counts["packed_flash_attention"] > 0, paged_counts
    for i in first_logits:
        assert torch.equal(prec.first_logits[i], first_logits[i]), f"first logits {i} differ"
    assert len(prec.step_logits) == len(step_logits), (len(prec.step_logits), len(step_logits))
    # the paged kernel gives the dense kernel's bits over the same rows
    for n, ((pa, pl), (da, dl)) in enumerate(zip(prec.step_logits, step_logits)):
        assert pa == da, (pa, da)
        assert torch.equal(pl, dl), f"decode step {n}: paged logits differ from dense"
    agree = sum(x == y for i in recs for x, y in zip(precs[i].tokens, recs[i].tokens))
    log(f"paged vs dense: first-token and all {len(step_logits)} decode steps' logits "
        f"equal, tokens agreeing {agree}/{NEW_TOKENS * len(recs)}")
    assert peng._paged.pool.n_used == 0
    paged_inputs = prec.decode_inputs
    del peng, prec
    torch.cuda.empty_cache()

    # ---- per-request prefill phase ----------------------------------------
    zero_counts()
    flash_full, flash_suffix = per_request_prefill(
        cfg, params, reqs, recompute_logits, load_req, artifact, first_logits)
    prefill_counts = counts()
    log(f"per-request prefill launches: {prefill_counts}")
    assert prefill_counts["flash_attention"] == cfg.n_layers * (len(reqs) + 2), prefill_counts
    assert sum(prefill_counts.values()) == prefill_counts["flash_attention"], prefill_counts
    del params, artifact
    torch.cuda.empty_cache()

    # ---- kernel phase -----------------------------------------------------
    kernels = [check_packed(packed_inputs, dense_counts["packed_flash_attention"]),
               check_decode(decode_inputs, dense_counts["decode_attention"]),
               check_flash(flash_full, prefill_counts["flash_attention"], "full"),
               check_paged(paged_inputs, paged_counts["paged_decode_attention"])]
    check_flash(flash_suffix, prefill_counts["flash_attention"], "suffix")
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
