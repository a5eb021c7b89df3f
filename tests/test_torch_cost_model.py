"""The port's cost model and ``PerfModel`` against the JAX package's.

``tests/test_cost_model.py`` and ``tests/test_perf_model.py`` replayed on
``repro_torch.core``: every value the reference's tests read is computed by
both packages on the same inputs (each package's own config of the arch,
field for field the same; the hardware and prices converted field by field)
and held equal at 1e-9 relative, and the reference's assertions are made on
the port's values.

  * ``TestPaperNumbers``: the paper's numbers on ``llama-7b`` with
    ``V100_X4_HF``, ``V100_X1_PAPER`` and ``AWS_PAPER``.
  * ``TestProperties``: the structural properties over every registered
    arch (the eleven of the reference), on seeded grids of the reference's
    hypothesis ranges, with its MQA case on ``granite-34b``; the
    reference's TPU case becomes an H100 one (``h100``, ``h100_pricing``).
  * ``PerfModel`` on ``h100`` and ``V100_X4`` over every registered arch,
    with the reference's sliding-window cases on ``mixtral-8x22b``
    (``tests/test_perf_model.py:56, 91``); its many-chip case runs on
    granite, as the reference's, and on nemo.

MoE archs price only their active parameters (``count_active_params``), so
``olmoe-1b-7b`` and ``mixtral-8x22b`` are where a port that counted every
expert would differ.  ``mixtral-8x22b`` stores and attends ``min(L,
window)`` rows a layer, so its stored bytes and decode time stop growing
past the window.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import cost_model as jcm
from repro.core import perf_model as jpm
from repro.core import pricing as jpr
from repro.models.registry import count_active_params as jcount_active
from repro_torch.configs import CONFIGS, get_config
from repro_torch.core import cost_model as cm
from repro_torch.core import perf_model as pm
from repro_torch.core import pricing as pr
from repro_torch.models.registry import count_active_params

ARCHS = sorted(CONFIGS)
REL = 1e-9
LLAMA, JLLAMA = get_config("llama-7b"), jget_config("llama-7b")


def _ref_hw(hw: pm.HardwareSpec) -> jpm.HardwareSpec:
    return jpm.HardwareSpec(**dataclasses.asdict(hw))


def _ref_pricing(p: pr.Pricing) -> jpr.Pricing:
    return jpr.Pricing(
        compute=jpr.ComputePrice(**dataclasses.asdict(p.compute)),
        tiers={n: jpr.StorageTier(**dataclasses.asdict(t)) for n, t in p.tiers.items()},
        default_tier=p.default_tier,
    )


def _both(hw: pm.HardwareSpec):
    """(port's PerfModel, the reference's on the same spec)."""
    return pm.PerfModel(hw), jpm.PerfModel(_ref_hw(hw))


def _same(got, want, where=""):
    """Equal at 1e-9 relative, field by field for a breakdown."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            _same(getattr(got, f.name), getattr(want, f.name), f"{where}.{f.name}")
    elif got is None or want is None:
        assert got is None and want is None, where
    else:
        assert got == pytest.approx(want, rel=REL), where
    return got


def _workloads(mod, n, seed):
    """``n`` workloads from the reference's hypothesis ranges, seeded."""
    rng = np.random.default_rng(seed)
    return [mod.Workload(L_context=int(rng.integers(512, 40_001)),
                         L_prompt=int(rng.integers(1, 257)),
                         L_output=int(rng.integers(1, 513)), N=int(rng.integers(1, 201)))
            for _ in range(n)]


def _pairs(n, seed):
    return list(zip(_workloads(cm, n, seed), _workloads(jcm, n, seed)))


PM, JPM = pm.PerfModel(pm.V100_X4_HF), jpm.PerfModel(jpm.V100_X4_HF)
AWS, JAWS = pr.AWS_PAPER, jpr.AWS_PAPER


def test_paper_specs_are_the_references():
    """The paper's machines and catalog are the reference's, field by field."""
    for port, ref in ((pm.V100_X4_HF, jpm.V100_X4_HF), (pm.V100_X1_PAPER, jpm.V100_X1_PAPER),
                      (pm.V100_X4, jpm.V100_X4)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(_ref_pricing(AWS)) == dataclasses.asdict(JAWS)


# --------------------------------------------------------------------------- #
# The paper's numbers (§2 Insights, footnotes 1-2)
# --------------------------------------------------------------------------- #
class TestPaperNumbers:
    def test_kv_size_10k_tokens_is_5p2_gb(self):
        s = _same(cm.s_storage_bytes(LLAMA, 10_000), jcm.s_storage_bytes(JLLAMA, 10_000))
        assert s / pr.GB == pytest.approx(5.24, abs=0.1)

    def test_storage_cost_per_hour_matches_8p8e4(self):
        per_hour = AWS.tier("io2").cost_per_gb_hour * cm.s_storage_bytes(LLAMA, 10_000) / pr.GB
        jper_hour = JAWS.tier("io2").cost_per_gb_hour * jcm.s_storage_bytes(
            JLLAMA, 10_000) / jpr.GB
        assert _same(per_hour, jper_hour) == pytest.approx(8.8e-4, rel=0.1)

    def test_prefill_cost_matches_0p0058(self):
        t = pm.PerfModel(pm.V100_X1_PAPER).t_prefill(LLAMA, 10_000)
        _same(t, jpm.PerfModel(jpm.V100_X1_PAPER).t_prefill(JLLAMA, 10_000))
        assert 3.0 / 3600.0 * t == pytest.approx(5.8e-3, rel=0.15)

    def test_prefill_cost_over_7x_storage(self):
        prefill = 3.0 / 3600.0 * pm.PerfModel(pm.V100_X1_PAPER).t_prefill(LLAMA, 10_000)
        storage = AWS.tier("io2").cost_per_gb_hour * cm.s_storage_bytes(LLAMA, 10_000) / pr.GB
        assert prefill / storage > 6.0

    def test_break_even_is_about_once_per_hour(self):
        w = cm.Workload(L_context=10_000, L_prompt=32, L_output=32, N=1)
        jw = jcm.Workload(L_context=10_000, L_prompt=32, L_output=32, N=1)
        n_star = _same(cm.break_even_reuses(LLAMA, w, AWS, PM),
                       jcm.break_even_reuses(JLLAMA, jw, JAWS, JPM))
        assert n_star is not None and n_star <= 3

    def test_delay_saving_band_at_10k(self):
        w = cm.Workload(L_context=10_000, L_prompt=32, L_output=32, N=5)
        jw = jcm.Workload(L_context=10_000, L_prompt=32, L_output=32, N=5)
        dt = _same(cm.delay_text(LLAMA, w, PM), jcm.delay_text(JLLAMA, jw, JPM))
        dk = _same(cm.delay_kv(LLAMA, w, PM, tier=AWS.tier("io2")),
                   jcm.delay_kv(JLLAMA, jw, JPM, tier=JAWS.tier("io2")))
        assert 1.5 <= dt.e2e_s / dk.e2e_s <= 4.0

    def test_cost_saving_band(self):
        w = cm.Workload(L_context=10_000, L_prompt=32, L_output=32, N=5)
        jw = jcm.Workload(L_context=10_000, L_prompt=32, L_output=32, N=5)
        r = _same(cm.cost_ratio(LLAMA, w, AWS, PM), jcm.cost_ratio(JLLAMA, jw, JAWS, JPM))
        assert 1.3 <= r <= 4.5


# --------------------------------------------------------------------------- #
# Structural properties, over the registered archs
# --------------------------------------------------------------------------- #
class TestProperties:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_costs_positive_and_storage_small(self, arch):
        """Every cost term equals the reference's; compute is positive and
        storage under a quarter of the total (the paper's insight, which the
        reference asserts on llama-7b, holds on every registered arch)."""
        cfg, jcfg = get_config(arch), jget_config(arch)
        for w, jw in _pairs(30, seed=1):
            ck = _same(cm.cost_kv(cfg, w, AWS, PM), jcm.cost_kv(jcfg, jw, JAWS, JPM), arch)
            _same(cm.cost_text(cfg, w, AWS, PM), jcm.cost_text(jcfg, jw, JAWS, JPM), arch)
            assert ck.compute > 0 and ck.storage >= 0 and ck.transmission >= 0
            assert ck.storage < 0.25 * ck.total

    @pytest.mark.parametrize("arch", ARCHS)
    def test_ratio_grows_with_reuse_count(self, arch):
        cfg, jcfg = get_config(arch), jget_config(arch)
        for w, jw in _pairs(30, seed=2):
            r1 = _same(cm.cost_ratio(cfg, w, AWS, PM), jcm.cost_ratio(jcfg, jw, JAWS, JPM))
            w2, jw2 = (dataclasses.replace(x, N=x.N + 50) for x in (w, jw))
            r2 = _same(cm.cost_ratio(cfg, w2, AWS, PM), jcm.cost_ratio(jcfg, jw2, JAWS, JPM))
            assert r2 >= r1 - 1e-9

    @pytest.mark.parametrize("arch", ARCHS)
    def test_simplified_ratio_approximates_full_model(self, arch):
        """The closed form is at least 1 and the full ratio never exceeds it
        by more than the attention superadditivity margin (a few %)."""
        cfg, jcfg = get_config(arch), jget_config(arch)
        for w, jw in _pairs(30, seed=3):
            simp = _same(cm.simplified_ratio(cfg, w, PM), jcm.simplified_ratio(jcfg, jw, JPM))
            full = _same(cm.cost_ratio(cfg, w, AWS, PM), jcm.cost_ratio(jcfg, jw, JAWS, JPM))
            assert simp >= 1.0
            assert full <= simp * 1.05

    @pytest.mark.parametrize("arch", ARCHS)
    def test_compression_never_hurts(self, arch):
        cfg, jcfg = get_config(arch), jget_config(arch)
        for i, (w, jw) in enumerate(_pairs(20, seed=4)):
            comp = (0.5, 1.0)[i % 2]
            full = _same(cm.cost_kv(cfg, w, AWS, PM, compression=1.0),
                         jcm.cost_kv(jcfg, jw, JAWS, JPM, compression=1.0)).total
            half = _same(cm.cost_kv(cfg, w, AWS, PM, compression=comp),
                         jcm.cost_kv(jcfg, jw, JAWS, JPM, compression=comp)).total
            assert half <= full + 1e-12

    @pytest.mark.parametrize("arch", ARCHS)
    def test_storage_bytes_structure(self, arch):
        """``tests/test_cost_model.py:133``: O(1) in L for attention-free
        archs, constant past the window for a sliding-window one, growing
        otherwise."""
        cfg, jcfg = get_config(arch), jget_config(arch)
        rng = np.random.default_rng(5)
        for L in rng.integers(1_000, 64_001, 20).tolist():
            s = _same(cm.s_storage_bytes(cfg, L), jcm.s_storage_bytes(jcfg, L))
            s2 = _same(cm.s_storage_bytes(cfg, 2 * L), jcm.s_storage_bytes(jcfg, 2 * L))
            assert s > 0
            if cfg.family == "ssm":
                assert s2 == s  # O(1) in L for attention-free archs
            elif cfg.sliding_window:
                w = cfg.sliding_window
                assert _same(cm.s_storage_bytes(cfg, 10 * w), jcm.s_storage_bytes(
                    jcfg, 10 * w)) == cm.s_storage_bytes(cfg, 20 * w)
                assert s2 >= s
            else:
                assert s2 > s

    def test_window_caps_stored_bytes(self):
        """mixtral-8x22b stores ``min(L, 4096)`` rows a layer: 4,096 rows of
        56 layers x 8 kv heads x 128 x K and V in bf16 at every length past
        the window, and ``L`` rows below it."""
        cfg, jcfg = get_config("mixtral-8x22b"), jget_config("mixtral-8x22b")
        per_row = 56 * 2 * 8 * 128 * 2
        for L in (1, 1000, 4095, 4096, 4097, 6000, 65_536):
            s = _same(cm.s_storage_bytes(cfg, L), jcm.s_storage_bytes(jcfg, L))
            assert s == min(L, 4096) * per_row

    def test_mqa_cheaper_to_store_than_mha(self):
        """``tests/test_cost_model.py:150``: granite's MQA (one kv head of
        128) stores 32x less than llama's MHA (32 heads of 128) a layer,
        and its stored bytes are the reference's at every length."""
        g, jg = get_config("granite-34b"), jget_config("granite-34b")
        per_tok_g = g.kv_bytes_per_token() / g.n_layers
        per_tok_l = LLAMA.kv_bytes_per_token() / LLAMA.n_layers
        assert per_tok_l / per_tok_g == pytest.approx(32.0, rel=0.01)
        assert g.kv_bytes_per_token() == jg.kv_bytes_per_token() == 88 * 2 * 128 * 2
        for L in (1, 2032, 32_768):
            assert _same(cm.s_storage_bytes(g, L), jcm.s_storage_bytes(jg, L)) == (
                L * g.kv_bytes_per_token())

    def test_gqa_cheaper_to_store_than_mha(self):
        """GQA follows MQA's rule: nemo's 8 kv heads store a quarter of
        llama's 32 per layer (both hd 128)."""
        nemo = get_config("mistral-nemo-12b")
        per_tok_n = nemo.kv_bytes_per_token() / nemo.n_layers
        per_tok_l = LLAMA.kv_bytes_per_token() / LLAMA.n_layers
        assert per_tok_l / per_tok_n == pytest.approx(4.0, rel=0.01)
        assert nemo.kv_bytes_per_token() == jget_config("mistral-nemo-12b").kv_bytes_per_token()

    @pytest.mark.parametrize("arch", ARCHS)
    def test_h100_target_also_benefits(self, arch):
        """The reference's TPU case on the port's target: one H100 at p5
        prices still favours reuse for long contexts."""
        perf, jperf = _both(pm.h100(1))
        price = pr.h100_pricing(1)
        w = cm.Workload(L_context=32_768, L_prompt=64, L_output=64, N=10)
        jw = jcm.Workload(L_context=32_768, L_prompt=64, L_output=64, N=10)
        r = _same(cm.cost_ratio(get_config(arch), w, price, perf),
                  jcm.cost_ratio(jget_config(arch), jw, _ref_pricing(price), jperf))
        assert r > 1.0


# --------------------------------------------------------------------------- #
# PerfModel (tests/test_perf_model.py) on the H100 and the paper's V100s
# --------------------------------------------------------------------------- #
HW = {"h100": pm.h100(1), "V100_X4": pm.V100_X4}


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_are_the_references(arch):
    """Every modelled FLOP and weight byte starts here; MoE counts top-k."""
    assert count_active_params(get_config(arch)) == jcount_active(jget_config(arch))


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_superadditive_and_monotone(arch, hw):
    perf, jperf = _both(HW[hw])
    cfg, jcfg = get_config(arch), jget_config(arch)
    rng = np.random.default_rng(6)
    for L, k in zip(rng.integers(128, 65_537, 25).tolist(), rng.integers(2, 9, 25).tolist()):
        t1 = _same(perf.t_prefill(cfg, L), jperf.t_prefill(jcfg, L))
        t2 = _same(perf.t_prefill(cfg, k * L), jperf.t_prefill(jcfg, k * L))
        assert _same(perf.t_prefill(cfg, L + 1), jperf.t_prefill(jcfg, L + 1)) >= t1
        flops = _same(perf.prefill_flops(cfg, L), jperf.prefill_flops(jcfg, L))
        h = perf.hw
        if flops / (h.devices * h.peak_flops * h.mfu) >= t1 * 0.999:  # compute-bound
            assert t2 >= k * t1 * 0.999


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_linear_in_output_and_monotone_in_context(arch, hw):
    perf, jperf = _both(HW[hw])
    cfg, jcfg = get_config(arch), jget_config(arch)
    rng = np.random.default_rng(7)
    for L_out, ctx in zip(rng.integers(1, 513, 25).tolist(),
                          rng.integers(128, 32_769, 25).tolist()):
        t = _same(perf.t_decode(cfg, L_out, ctx), jperf.t_decode(jcfg, L_out, ctx))
        one = _same(perf.t_decode(cfg, 1, ctx), jperf.t_decode(jcfg, 1, ctx))
        two = _same(perf.t_decode(cfg, 1, 2 * ctx), jperf.t_decode(jcfg, 1, 2 * ctx))
        assert t == pytest.approx(L_out * one, rel=1e-6)
        if cfg.family == "ssm":
            assert two == pytest.approx(one, rel=1e-9)
        else:
            assert two >= one


@pytest.mark.parametrize("hw", sorted(HW))
def test_swa_decode_time_bounded_by_window(hw):
    """``tests/test_perf_model.py:56``: past the window a decode step reads
    the same rows whatever the context, on both packages."""
    perf, jperf = _both(HW[hw])
    cfg, jcfg = get_config("mixtral-8x22b"), jget_config("mixtral-8x22b")
    w = cfg.sliding_window
    for batch in (1, 4):
        t10 = _same(perf.t_decode(cfg, 1, 10 * w, batch=batch),
                    jperf.t_decode(jcfg, 1, 10 * w, batch=batch))
        t20 = _same(perf.t_decode(cfg, 1, 20 * w, batch=batch),
                    jperf.t_decode(jcfg, 1, 20 * w, batch=batch))
        assert t10 == pytest.approx(t20, rel=1e-9)
        assert perf.t_decode(cfg, 1, w // 2, batch=batch) < t10


@pytest.mark.parametrize("hw", sorted(HW))
def test_paged_decode_caps_each_slot_at_the_window(hw):
    """``tests/test_perf_model.py:91``'s sliding-window case: the paged
    price caps each slot's live context at the window."""
    perf, jperf = _both(HW[hw])
    cfg, jcfg = get_config("mixtral-8x22b"), jget_config("mixtral-8x22b")
    w = cfg.sliding_window
    for lens in ([10 * w, w], [20 * w, w], [3 * w, w // 2, 7, w + 1]):
        _same(perf.t_decode_paged(cfg, lens), jperf.t_decode_paged(jcfg, lens), lens)
    assert perf.t_decode_paged(cfg, [10 * w, w]) == pytest.approx(
        perf.t_decode_paged(cfg, [20 * w, w]), rel=1e-9)


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("arch", ARCHS)
def test_batched_decode_amortises_weights(arch, hw):
    perf, jperf = _both(HW[hw])
    cfg, jcfg = get_config(arch), jget_config(arch)
    t1 = _same(perf.t_decode(cfg, 1, 4096, batch=1), jperf.t_decode(jcfg, 1, 4096, batch=1))
    t32 = _same(perf.t_decode(cfg, 1, 4096, batch=32), jperf.t_decode(jcfg, 1, 4096, batch=32))
    assert t32 < 32 * t1
    if cfg.family != "ssm":  # KV reads scale with the batch
        assert t32 > t1


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_prices_live_blocks(arch, hw):
    perf, jperf = _both(HW[hw])
    cfg, jcfg = get_config(arch), jget_config(arch)
    lens = [512, 4096, 1024, 256]
    paged = _same(perf.t_decode_paged(cfg, lens), jperf.t_decode_paged(jcfg, lens))
    dense = _same(perf.t_decode(cfg, 1, max(lens), batch=4),
                  jperf.t_decode(jcfg, 1, max(lens), batch=4))
    shortest = perf.t_decode(cfg, 1, min(lens), batch=4)
    if cfg.family == "ssm":  # no per-position state: every slot costs alike
        assert paged == pytest.approx(dense, rel=1e-9)
    else:
        assert shortest < paged < dense
    assert perf.t_decode_paged(cfg, [2048] * 4) == perf.t_decode(cfg, 1, 2048, batch=4)
    assert perf.t_decode_paged(cfg, [777]) == perf.t_decode(cfg, 1, 777, batch=1)
    assert perf.t_decode_paged(cfg, []) == 0.0
    grown = [512, 8192, 1024, 256]
    assert _same(perf.t_decode_paged(cfg, grown), jperf.t_decode_paged(jcfg, grown)) >= paged


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_prefill_prices_recompute_fraction(arch, hw):
    perf, jperf = _both(HW[hw])
    cfg, jcfg = get_config(arch), jget_config(arch)
    L = 8192
    full = _same(perf.t_prefill(cfg, L), jperf.t_prefill(jcfg, L))
    for n in (0, 1, 512, int(0.15 * L), 2048, L, 10 * L):
        _same(perf.t_prefill_fused(cfg, L, n), jperf.t_prefill_fused(jcfg, L, n), (arch, n))
    assert 0 < perf.t_prefill_fused(cfg, L, int(0.15 * L)) < full
    assert perf.t_prefill_fused(cfg, L, 2048) >= perf.t_prefill_fused(cfg, L, 512)
    assert perf.t_prefill_fused(cfg, L, L) == full == perf.t_prefill_fused(cfg, L, 10 * L)
    assert perf.t_prefill_fused(cfg, L, 0) == 0.0 == perf.t_prefill_fused(cfg, 0, 128)
    h = perf.hw
    param_read = count_active_params(cfg) * 2 / (h.devices * h.hbm_bw * h.membw_eff)
    assert perf.t_prefill_fused(cfg, L, 1) >= param_read


def test_more_chips_never_slower():
    cfg, jcfg = get_config("mistral-nemo-12b"), jget_config("mistral-nemo-12b")
    (small, jsmall), (big, jbig) = _both(pm.h100(1)), _both(pm.h100(8))
    for L in (4096, 32_768):
        assert _same(big.t_prefill(cfg, L), jbig.t_prefill(jcfg, L)) <= _same(
            small.t_prefill(cfg, L), jsmall.t_prefill(jcfg, L))
        assert _same(big.t_decode(cfg, 1, L), jbig.t_decode(jcfg, 1, L)) <= _same(
            small.t_decode(cfg, 1, L), jsmall.t_decode(jcfg, 1, L))


def test_more_chips_never_slower_on_granite():
    """``tests/test_perf_model.py:126`` on its own arch, granite-34b: eight
    H100s never model a slower prefill or decode than one."""
    cfg, jcfg = get_config("granite-34b"), jget_config("granite-34b")
    (small, jsmall), (big, jbig) = _both(pm.h100(1)), _both(pm.h100(8))
    assert _same(big.t_prefill(cfg, 32_768), jbig.t_prefill(jcfg, 32_768)) <= _same(
        small.t_prefill(cfg, 32_768), jsmall.t_prefill(jcfg, 32_768))
    assert _same(big.t_decode(cfg, 1, 32_768), jbig.t_decode(jcfg, 1, 32_768)) <= _same(
        small.t_decode(cfg, 1, 32_768), jsmall.t_decode(jcfg, 1, 32_768))


def test_kv_load_time_scales_with_hosts():
    """A p5 host holds 8 H100s: 256 of them span 32 hosts, whose storage
    mounts read in parallel."""
    one_hw = pm.h100(8)
    many_hw = dataclasses.replace(pm.h100(256), hosts=32)
    tier, jtier = pr.AWS_PAPER.tier("io2"), jpr.AWS_PAPER.tier("io2")
    one = _same(pm.PerfModel(one_hw).kv_load_time(5.24e9, tier),
                jpm.PerfModel(_ref_hw(one_hw)).kv_load_time(5.24e9, jtier))
    many = _same(pm.PerfModel(many_hw).kv_load_time(5.24e9, tier),
                 jpm.PerfModel(_ref_hw(many_hw)).kv_load_time(5.24e9, jtier))
    assert many < one / 8
