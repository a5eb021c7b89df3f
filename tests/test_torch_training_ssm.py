"""The SSD scan's backward and the training inputs of the SSM and
encoder-decoder families, on the CPU.

  * ``ssd_chunked_bwd_plain`` (the equations the CUDA backward runs) against
    ``jax.grad`` of the reference's ``ops.ssd_chunked_jnp`` and against
    torch autograd through ``ssd_chunked_plain``, at the reference's SSD
    tolerance: G 1 and G > 1, a padded last chunk, an initial state and the
    final state's gradient both given and both absent, and chunk lengths
    that differ between the two sides;
  * ``ops.SSDChunkedFn`` against autograd of the plain forward, and
    ``ops.ssd_chunked`` keeping its serving path without a gradient;
  * ``frame_batches`` (the encoder-decoder's training batches), the
    training launcher on the SSM and encoder-decoder families, and
    ``scripts/train_loss_rehearsal.py`` at the reduced config.

The reduced archs' loss and gradients against the reference ride in
``tests/test_torch_training.py`` (``TRAIN_ARCHS``).
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ops import ssd_chunked_jnp  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data.synthetic import frame_batches, token_batches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

torch.set_num_threads(1)
# the reference's SSD tolerance (tests/test_kernels.py), f32
SSD_ATOL = 5e-5

# name: (B, L, H, P, G, S, port chunk, reference chunk, with state and dhT)
CASES = {
    "g1-states": (2, 40, 4, 8, 1, 16, 16, 16, True),
    "groups-padded": (2, 37, 4, 8, 2, 16, 16, 16, False),
    "chunks-differ": (1, 40, 4, 8, 1, 8, 32, 16, True),
    "groups-padded-states": (2, 21, 6, 8, 3, 8, 8, 16, True),
    "one-chunk": (1, 12, 2, 16, 1, 16, 16, 32, False),
}
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def _inputs(case, seed=0):
    B, L, H, P, G, S, chunk, jchunk, states = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (rng.random((B, L, H)) * 0.5 + 0.01).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, S)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, S)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, S)).astype(np.float32) if states else None
    dhT = rng.standard_normal((B, H, P, S)).astype(np.float32) if states else None
    return (x, dt, A, Bm, Cm), dy, h0, dhT, chunk, jchunk


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _check(got, want, names=NAMES):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=SSD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_jax_grad(case):
    ins, dy, h0, dhT, chunk, jchunk = _inputs(case)

    def f(x, dt, A, Bm, Cm, h0):
        y, hT = ssd_chunked_jnp(x, dt, A, Bm, Cm, chunk=jchunk, initial_state=h0)
        out = jnp.sum(y * jnp.asarray(dy))
        return out if dhT is None else out + jnp.sum(hT * jnp.asarray(dhT))

    args = [jnp.asarray(a) for a in ins] + [None if h0 is None else jnp.asarray(h0)]
    want = list(jax.grad(f, argnums=(0, 1, 2, 3, 4) + ((5,) if h0 is not None else ()))(*args))
    got = ssk.ssd_chunked_bwd_plain(*map(_t, ins), _t(dy), _t(dhT), chunk=chunk,
                                    initial_state=_t(h0))
    assert [g.dtype for g in got[:5]] == [torch.float32] * 5
    _check([None if g is None else g.numpy() for g in got], want + [None] * (6 - len(want)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_autograd_of_plain_forward(case):
    ins, dy, h0, dhT, chunk, _ = _inputs(case, seed=1)
    leaves = [_t(a).requires_grad_(True) for a in ins]
    h0t = None if h0 is None else _t(h0).requires_grad_(True)
    # autograd through the forward at another chunk: the chunked form is
    # exact for any chunk length
    y, hT = ssk.ssd_chunked_plain(*leaves, chunk=chunk * 2, initial_state=h0t)
    loss = (y * _t(dy)).sum() + (0 if dhT is None else (hT * _t(dhT)).sum())
    want = torch.autograd.grad(loss, leaves + ([h0t] if h0t is not None else []))
    got = ssk.ssd_chunked_bwd_plain(*map(_t, ins), _t(dy), _t(dhT), chunk=chunk,
                                    initial_state=_t(h0))
    _check([None if g is None else g.numpy() for g in got],
           [w.numpy() for w in want] + [None] * (6 - len(want)))


@pytest.mark.parametrize("case", ["g1-states", "groups-padded"])
def test_ssd_fn_matches_autograd_of_plain_forward(case):
    ins, dy, h0, dhT, chunk, _ = _inputs(case, seed=2)
    results = []
    for fn in (ops.ssd_chunked, ssk.ssd_chunked_plain):
        leaves = [_t(a).requires_grad_(True) for a in ins]
        h0t = None if h0 is None else _t(h0).requires_grad_(True)
        y, hT = fn(*leaves, chunk=chunk, initial_state=h0t)
        loss = (y * _t(dy)).sum() + (0 if dhT is None else (hT * _t(dhT)).sum())
        grads = torch.autograd.grad(loss, leaves + ([h0t] if h0t is not None else []))
        results.append((y.detach(), hT.detach(), grads))
    (y1, h1, g1), (y2, h2, g2) = results
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=SSD_ATOL, rtol=0)


def test_ssd_fn_takes_only_the_gradients_it_is_asked_for():
    """y alone carries the loss (the model drops the final state): the
    backward runs without dhT; an operand that needs no gradient gets none."""
    ins, dy, _, _, chunk, _ = _inputs("groups-padded", seed=3)
    x, dt, A, Bm, Cm = map(_t, ins)
    dt.requires_grad_(True)
    y, _ = ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    (got,) = torch.autograd.grad((y * _t(dy)).sum(), [dt])
    want = ssk.ssd_chunked_bwd_plain(x, dt.detach(), A, Bm, Cm, _t(dy), chunk=chunk)[1]
    assert torch.equal(got, want)


def test_ssd_chunked_without_grad_takes_the_serving_path():
    ins, _, h0, _, chunk, _ = _inputs("g1-states")
    leaves = [_t(a).requires_grad_(True) for a in ins]
    with torch.inference_mode():
        y, _ = ops.ssd_chunked(*[t.detach() for t in leaves], chunk=chunk)
    assert y.grad_fn is None
    with torch.no_grad():
        assert ops.ssd_chunked(*leaves, chunk=chunk)[0].grad_fn is None
    grad_fn = ops.ssd_chunked(*leaves, chunk=chunk, initial_state=_t(h0))[0].grad_fn
    assert type(grad_fn).__name__ == "SSDChunkedFnBackward"


def test_frame_batches_carry_token_batches_draws():
    cfg = reduced_config(get_config("whisper-tiny"))
    frames, tokens = frame_batches(cfg, batch=3, seq_len=12, seed=4), token_batches(
        cfg, batch=3, seq_len=12, seed=4)
    for _ in range(2):
        got, want = next(frames), next(tokens)
        assert got["frames"].shape == (3, cfg.encoder_seq_len, cfg.d_model)
        assert got["frames"].dtype == np.float32
        np.testing.assert_array_equal(got["dec_tokens"], want["tokens"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(got["mask"], want["mask"])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "whisper-tiny"])
def test_train_launcher_trains_the_family(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--device", "cpu", "--reduced", "--steps", "4", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    out = train_cli.main(argv)
    assert out["completed"] == 4 and np.isfinite(out["metrics"]["loss"])
    assert capsys.readouterr().out.startswith(f"{arch}-smoke: step 4 loss ")
    again = train_cli.main(argv + ["--steps", "5"])  # resumes from step 4
    assert again["completed"] == 5 and int(again["opt_state"].step) == 5


def test_train_loss_rehearsal_runs(capsys):
    """``scripts/train_loss_rehearsal.py`` (the CPU rehearsal behind
    ``chip_smoke.py``'s loss-drop gate) at the reduced config: it trains,
    the loss falls and it prints the drop it returns."""
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "train_loss_rehearsal.py"
    spec = importlib.util.spec_from_file_location("train_loss_rehearsal", path)
    rehearsal = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rehearsal)
    losses = rehearsal.main(["--reduced", "--layers", "2", "--batch", "2", "--seq", "32",
                             "--steps", "8", "--warmup", "2", "--lr", "3e-3", "--data-vocab",
                             "64", "--threads", "1"])
    assert len(losses) == 8 and all(np.isfinite(losses))
    drop = sum(losses[:3]) / 3 - sum(losses[-3:]) / 3
    assert drop > 0, losses
    assert capsys.readouterr().out.rstrip().endswith(f"drop of the 3-step means {drop:.4f}")
