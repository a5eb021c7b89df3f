"""The port's SSM family against the JAX package: the SSD scan and mamba2-1.3b.

On the CPU the port's ``ops.ssd_chunked`` runs its plain version
(``ssd_scan.ssd_chunked_plain``); these tests hold it against the
reference's sequential oracle ``ref.ssd_scan_ref``, its jnp chunked path
``ops.ssd_chunked_jnp`` and its Pallas kernel in interpret mode, on the same
numpy inputs, at the reference's SSD atol 5e-5 (f32).  The reduced
mamba2-1.3b runs on weights converted from the reference's (``api.init(
jax.random.PRNGKey(2), cfg)``): logits and states at atol 1e-4, greedy tokens
identical.  The CUDA kernel runs only on the card
(``tests/test_torch_kernels_gpu.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunked as pallas_ssd  # noqa: E402
from repro.kvcache import compression as jcompression  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402
from repro_torch.kvcache import compression, faults, paged  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.models.blocks import BlockCache  # noqa: E402
from repro_torch.models.ssm import MambaState  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

torch.set_num_threads(1)
SSD_ATOL = 5e-5
MODEL_ATOL = 1e-4
ARCH = "mamba2-1.3b"

# tests/test_kernels.py's four shapes, then L below the Pallas kernel's
# 8-token minimum chunk, and L = 1
SSD_SHAPES = [
    # (B, L, H, P, G, S, chunk)
    (1, 16, 2, 8, 1, 8, 8),
    (2, 40, 4, 8, 2, 16, 16),
    (1, 64, 8, 16, 1, 32, 32),
    (2, 24, 4, 8, 4, 8, 8),
    (2, 5, 4, 8, 2, 16, 16),
    (1, 1, 2, 8, 1, 8, 8),
]


def _ssd_inputs(B, L, H, P, G, S, seed=0):
    """The reference kernel test's inputs, as numpy: x, B, C standard
    normal, dt = |N| / 10, A = -|N| - 0.1, h0 = N / 10."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((B, L, H, P)).astype(f),
        dt=(np.abs(rng.standard_normal((B, L, H))) * 0.1).astype(f),
        A=(-np.abs(rng.standard_normal(H)) - 0.1).astype(f),
        B_=rng.standard_normal((B, L, G, S)).astype(f),
        C=rng.standard_normal((B, L, G, S)).astype(f),
        h0=(rng.standard_normal((B, H, P, S)) * 0.1).astype(f),
    )


def _args(a, to):
    return [to(a[n]) for n in ("x", "dt", "A", "B_", "C")]


@pytest.mark.parametrize("B,L,H,P,G,S,chunk", SSD_SHAPES)
def test_plain_ssd_matches_oracle_jnp_path_and_pallas_interpret(B, L, H, P, G, S, chunk):
    a = _ssd_inputs(B, L, H, P, G, S, seed=L)
    y, hT = ops.ssd_chunked(*_args(a, torch.from_numpy), chunk=chunk,
                            initial_state=torch.from_numpy(a["h0"]))
    assert y.shape == (B, L, H, P) and hT.shape == (B, H, P, S) and hT.dtype == torch.float32
    jargs, jh0 = _args(a, jnp.asarray), jnp.asarray(a["h0"])
    wants = {
        "oracle": jref.ssd_scan_ref(*jargs, initial_state=jh0),
        "jnp": jops.ssd_chunked_jnp(*jargs, chunk=chunk, initial_state=jh0),
        "pallas": pallas_ssd(*jargs, chunk=chunk, initial_state=jh0, interpret=True),
    }
    for name, (wy, wh) in wants.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SSD_ATOL, err_msg=name)
        np.testing.assert_allclose(hT.numpy(), np.asarray(wh), atol=SSD_ATOL, err_msg=name)
    # no initial state: a zero one
    y0, h0 = ssk.ssd_chunked_plain(*_args(a, torch.from_numpy), chunk=chunk)
    wy0, wh0 = jref.ssd_scan_ref(*jargs)
    np.testing.assert_allclose(y0.numpy(), np.asarray(wy0), atol=SSD_ATOL)
    np.testing.assert_allclose(h0.numpy(), np.asarray(wh0), atol=SSD_ATOL)


def test_ssd_state_carry_equals_full_scan():
    """Suffix-prefill invariant (``tests/test_kernels.py:205``): scanning
    [a|b] == scan(a), then scan(b) from its state."""
    a = _ssd_inputs(1, 32, 2, 8, 1, 8, seed=7)
    x, dt, A, Bm, Cm = _args(a, torch.from_numpy)
    y_full, h_full = ssk.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=8)
    half = 16
    _, h1 = ssk.ssd_chunked_plain(x[:, :half], dt[:, :half], A, Bm[:, :half], Cm[:, :half],
                                  chunk=8)
    y2, h2 = ssk.ssd_chunked_plain(x[:, half:], dt[:, half:], A, Bm[:, half:], Cm[:, half:],
                                   chunk=8, initial_state=h1)
    np.testing.assert_allclose(y2.numpy(), y_full[:, half:].numpy(), atol=SSD_ATOL)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=SSD_ATOL)


def test_torch_ssd_oracles_match_jnp():
    a = _ssd_inputs(2, 12, 4, 8, 2, 16, seed=3)
    y, h = ref.ssd_scan_ref(*_args(a, torch.from_numpy), initial_state=torch.from_numpy(a["h0"]))
    wy, wh = jref.ssd_scan_ref(*_args(a, jnp.asarray), initial_state=jnp.asarray(a["h0"]))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SSD_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=SSD_ATOL)
    # one decode step from the state, through ops (plain on every device)
    args = [a["x"][:, 0], a["dt"][:, 0], a["A"], a["B_"][:, 0], a["C"][:, 0]]
    yd, hd = ops.ssd_decode(h, *(torch.from_numpy(v) for v in args))
    wyd, whd = jref.ssd_decode_ref(wh, *(jnp.asarray(v) for v in args))
    np.testing.assert_allclose(yd.numpy(), np.asarray(wyd), atol=SSD_ATOL)
    np.testing.assert_allclose(hd.numpy(), np.asarray(whd), atol=SSD_ATOL)


def test_supported_copies_the_reference_predicate():
    from repro.kernels import ssd_scan as jssd

    for P, G, S in ((64, 1, 128), (256, 2, 256), (257, 1, 8), (8, 3, 8), (8, 1, 300)):
        a = _ssd_inputs(1, 4, 6, P, G, S)
        assert ssk.supported(*_args(a, torch.from_numpy)) == jssd.supported(
            *_args(a, jnp.asarray)), (P, G, S)


# --------------------------------------------------------------------------- #
# mamba2-1.3b
# --------------------------------------------------------------------------- #
def _setup(param_dtype=None, seed=2):
    over = {} if param_dtype is None else dict(param_dtype=param_dtype)
    jcfg = jreduced(jget_config(ARCH), **over)
    cfg = reduced_config(get_config(ARCH), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    params = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def test_config_and_param_count_match_reference():
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert registry.count_params(full) == jregistry.count_params(jfull)
    assert registry.count_params(reduced_config(full)) == jregistry.count_params(
        jreduced(jfull))
    assert full.fixed_state_bytes() == jfull.fixed_state_bytes()


def test_from_jax_params_keeps_the_ssd_leaves_f32():
    """At bf16 ``param_dtype`` the reference keeps ``A_log``, ``D_skip`` and
    ``dt_bias`` f32: so does the conversion, and ``lm.init``; every leaf
    holds the reference's values."""
    jcfg, jparams, cfg, params = _setup("bfloat16")
    jlayer = jax.tree_util.tree_map(lambda a: np.asarray(a[1], np.float32),
                                    jparams["layers"][0])
    for name, t in params["layers"][1]["mamba"].items():
        want = torch.float32 if name in ("A_log", "D_skip", "dt_bias") else torch.bfloat16
        assert t.dtype == want, name
        assert jparams["layers"][0]["mamba"][name].dtype == (
            jnp.float32 if want == torch.float32 else jnp.bfloat16), name
        np.testing.assert_array_equal(t.float().numpy(), jlayer["mamba"][name], err_msg=name)
    own = lm.init(cfg, seed=0, device="cpu")["layers"][0]["mamba"]
    assert {n: t.dtype for n, t in own.items()} == {
        n: t.dtype for n, t in params["layers"][1]["mamba"].items()}


def test_model_prefill_suffix_and_decode_match_reference():
    """``tests/test_models.py:112`` for mamba2, each path against the
    reference's same path at 1e-4: full prefill, suffix prefill after a
    prefix (the SSD's ``initial_state`` and the carried conv tail), the
    states they leave, and a decode step from each; greedy tokens equal.
    The suffix path also equals the full one (the reference's 3e-4)."""
    jcfg, jparams, cfg, params = _setup()
    api = jregistry.get_model(jcfg)
    rng = np.random.default_rng(0)
    B, S = 2, 24
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)

    def both(parts):
        js, ts = api.init_state(jcfg, B, 64), lm.init_state(cfg, B, 64, device="cpu")
        for part in parts:
            jl, js = api.prefill(jparams, jcfg, jnp.asarray(part), js)
            tl, ts = lm.prefill(params, cfg, torch.from_numpy(part), ts)
        return jl, js, tl, ts

    full = both([toks])
    suffix = both([toks[:, : S // 2], toks[:, S // 2:]])
    nxt = np.argmax(np.asarray(full[0]), -1)[:, None].astype(np.int32)
    for jl, js, tl, ts in (full, suffix):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_ATOL)
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
        assert ts.pos.tolist() == [S, S]
        for name in ("conv", "ssd"):
            np.testing.assert_allclose(getattr(ts.caches[0].mamba, name).numpy(),
                                       np.asarray(getattr(js.caches[0].mamba, name)),
                                       atol=MODEL_ATOL, err_msg=name)
        jd, _ = api.decode(jparams, jcfg, jnp.asarray(nxt), js)
        td, _ = lm.decode(params, cfg, torch.from_numpy(nxt), ts)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=MODEL_ATOL)
        assert (td.argmax(-1).numpy() == np.asarray(jd).argmax(-1)).all()
    np.testing.assert_allclose(suffix[2].numpy(), full[2].numpy(), atol=3e-4)


def test_state_artifact_is_the_reference_tree():
    """The stored context of an SSM arch is the same array tree in both
    packages (conv tail and f32 SSD state, no K/V): equal arrays, byte
    counts and checksums; inserting it into a fresh slot and prefilling the
    prompt gives the reference's logits."""
    jcfg, jparams, cfg, params = _setup()
    api = jregistry.get_model(jcfg)
    rng = np.random.default_rng(1)
    ctx = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab, (1, 6)).astype(np.int32)
    jst = api.init_state(jcfg, 2, 64)
    _, jst = api.prefill(jparams, jcfg, jnp.asarray(ctx), jst)
    st = lm.init_state(cfg, 2, 64, device="cpu")
    _, st = lm.prefill(params, cfg, torch.from_numpy(ctx), st)
    jart = jax.tree_util.tree_map(np.asarray, jpaged.extract_slot(jcfg, jst, 1, 20))
    art = paged.extract_slot(cfg, st, 1, 20)
    assert art.caches[0].attn is None and jart.caches[0].attn is None
    for name in ("conv", "ssd"):
        got, want = getattr(art.caches[0].mamba, name), getattr(jart.caches[0].mamba, name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, atol=MODEL_ATOL, err_msg=name)
    assert compression.tree_nbytes(art) == jcompression.tree_nbytes(jart)

    # the load path: the reference's stored snapshot into a fresh slot (and
    # back out, bit for bit: the checksum hashes the raw bytes), then the
    # prompt
    jm = jart.caches[0].mamba
    port_art = lm.LMState(pos=jart.pos, caches=(
        BlockCache(None, MambaState(np.array(jm.conv), np.array(jm.ssd))),))
    fresh = lm.init_state(cfg, 1, 64, device="cpu")
    paged.insert_slot(cfg, fresh, 0, port_art)
    assert int(fresh.pos[0]) == 20
    again = paged.extract_slot(cfg, fresh, 0, 20)
    assert faults.payload_checksum(again) == jfaults.payload_checksum(jart)
    tl, _ = lm.prefill(params, cfg, torch.from_numpy(prompt), fresh)
    jfresh = jpaged.insert_slot(jcfg, api.init_state(jcfg, 1, 64), 0, jart)
    jl, _ = api.prefill(jparams, jcfg, jnp.asarray(prompt), jfresh)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_ATOL)


@pytest.mark.parametrize("call", ["prefill_packed", "prefill_fused", "decode_paged",
                                  "prefill_chunked"])
def test_attention_only_calls_refuse_an_ssm_stack(call):
    """The reference asserts attention-only stacks in these calls; the port
    raises, naming the call."""
    cfg = reduced_config(get_config(ARCH))
    params = lm.init(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        getattr(lm, call)(params, cfg, torch.zeros((1, 4), dtype=torch.int32), (),
                          **{"prefill_packed": dict(q_pos=None, q_seg=None, q_rows=None,
                                                    kv_pos=None, kv_seg=None, last_idx=None),
                             "prefill_fused": dict(q_pos=None, q_rows=None, kv_pos=None,
                                                   last_idx=None),
                             "decode_paged": dict(block_table=None, pos=None),
                             "prefill_chunked": dict(block_table=None, q_pos=None,
                                                     last_idx=None)}[call])
