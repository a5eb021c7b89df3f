"""The port's serving launcher against the reference's.

``repro_torch.launch.serve`` and ``repro.launch.serve`` run with the same
arguments (the port's on the CPU) and must print the same summary and store
statistics, floats at 1e-9.  No printed field depends on the weights (the
port draws its own from a seeded torch generator): the workload sets no
end-of-sequence token, so every request generates ``--output-len`` tokens
whatever the model says, and every time and dollar is modelled from token
counts and stored bytes.  So no field is left out.
"""
import json
import sys

import pytest

pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ARGV = ["--requests", "8", "--contexts", "2", "--policy", "always", "--compress", "--json"]


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _port(capsys, argv):
    serve.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def _reference(capsys, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [ARGV, ARGV[:-2] + ["--policy", "cost", "--json"]],
                         ids=["always-compress", "cost"])
def test_launcher_prints_the_reference_summary(capsys, monkeypatch, argv):
    got = dict(_flat(json.loads(_port(capsys, argv))))
    want = dict(_flat(json.loads(_reference(capsys, monkeypatch, argv))))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k
    if "--compress" in argv:
        assert got["reuse_hits"] >= 4 and got["store.entries"] == 2


@pytest.mark.parametrize("policy", ["always", "cost"])
def test_launcher_serves_mamba2_as_the_reference(capsys, monkeypatch, policy):
    """``--arch mamba2-1.3b``: the SSM family rides the per-request
    admission path on both sides (reduced compute, full-size economics of
    the ~100 MB state artifacts); the same summary and store statistics."""
    argv = ["--arch", "mamba2-1.3b", "--requests", "8", "--contexts", "2", "--policy",
            policy, "--json"]
    got = dict(_flat(json.loads(_port(capsys, argv))))
    want = dict(_flat(json.loads(_reference(capsys, monkeypatch, argv))))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k
    if policy == "always":
        assert got["reuse_hits"] >= 4 and got["store.entries"] == 2


def test_launcher_text_output_matches_reference(capsys, monkeypatch):
    argv = ["--requests", "6", "--contexts", "2", "--compress"]
    assert _port(capsys, argv) == _reference(capsys, monkeypatch, argv)


@pytest.mark.parametrize("flag", ["--overlap", "--hedge"])
def test_overlap_and_hedge_flags_print_the_reference_output(capsys, monkeypatch, flag):
    """``--overlap`` and ``--hedge`` serve on the port: the text output is
    the reference's, and the ``--json`` summary and store statistics equal
    its own at 1e-9."""
    argv = ["--requests", "6", "--contexts", "2", flag]
    assert _port(capsys, argv) == _reference(capsys, monkeypatch, argv)
    got = dict(_flat(json.loads(_port(capsys, ARGV + [flag]))))
    want = dict(_flat(json.loads(_reference(capsys, monkeypatch, ARGV + [flag]))))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k


def test_h100_platform_serves_and_tpu_is_not_offered(capsys):
    out = json.loads(_port(capsys, ARGV + ["--platform", "h100"]))
    assert out["n_requests"] == 8 and out["compute_cost"] > 0
    with pytest.raises(SystemExit):
        serve.main(ARGV + ["--platform", "tpu", "--device", "cpu"])


@pytest.mark.parametrize("policy", ["always", "cost"])
def test_launcher_serves_olmoe_as_the_reference(capsys, monkeypatch, policy):
    """``--arch olmoe-1b-7b``: the MoE family packs like a dense arch, and its
    full-size economics price only the top-8 experts' parameters; the same
    summary and store statistics on both sides."""
    argv = ["--arch", "olmoe-1b-7b", "--requests", "8", "--contexts", "2", "--policy",
            policy, "--json"]
    got = dict(_flat(json.loads(_port(capsys, argv))))
    want = dict(_flat(json.loads(_reference(capsys, monkeypatch, argv))))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k
    if policy == "always":
        assert got["reuse_hits"] >= 4 and got["store.entries"] == 2


def test_launcher_serves_jamba_as_the_reference(capsys, monkeypatch):
    """``--arch jamba-1.5-large-398b``: the hybrid family rides the
    per-request admission path on both sides (reduced compute, the full
    arch's economics: 9 attention layers' K/V and 63 Mamba states); the
    same summary and store statistics."""
    argv = ["--arch", "jamba-1.5-large-398b", "--requests", "6", "--contexts", "2",
            "--policy", "always", "--json"]
    got = dict(_flat(json.loads(_port(capsys, argv))))
    want = dict(_flat(json.loads(_reference(capsys, monkeypatch, argv))))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k
    assert got["reuse_hits"] >= 4 and got["store.entries"] == 2
