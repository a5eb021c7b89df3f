"""Emulate the bf16 ``ssd_chunked`` kernel's split products on the CPU.

The kernel (``src/repro_torch/kernels/csrc/ssd_scan.cu``) feeds every f32
operand of a tensor-core product (x ⊙ w in the chunk states, M in the chunk
outputs, the state h_in before a chunk) to bf16 ``mma`` as parts: hi =
bf16(v), then the rest.  This script redoes the kernel's three steps in
PyTorch on the CPU with each of those operands split into two parts (hi,
lo) or three (hi, mid, lo), f32 sums, and holds the results to the rules
of the kernel tests: the bf16 y within one bf16 ulp plus 5e-5 of
``ssd_chunked_plain``, the final state within max(5e-5, the plain
version's error) of the f64 scan.  Inputs are drawn from a seed as
``tests/test_torch_kernels_gpu.py`` draws them, at the serve's widths with
fewer heads (P 64, S 128, G 1, 2,000 tokens after a stored state):

    python3 scripts/ssd_split_emulation.py [--heads 16] [--seeds 7 8]
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402


def bf(v):
    return v.to(torch.bfloat16).float()


def split(v, parts):
    """v as the sum of its bf16 parts, the last one rounded."""
    out = torch.zeros_like(v)
    for _ in range(parts - 1):
        out = out + bf(v - out)
    return out + bf(v - out)


def emulate(x, dt, A, Bm, Cm, h0, chunk, parts):
    """The kernel's three steps with (M, h_in, x ⊙ w) each split in
    ``parts[name]`` bf16 parts and every product summed in f32."""
    Bsz, L, H, P = x.shape
    G, S = Bm.shape[2:]
    nc = -(-L // chunk)
    pad = nc * chunk - L
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(H // G, 2)
    Cf = torch.nn.functional.pad(Cm.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(H // G, 2)
    y = torch.zeros(Bsz, nc * chunk, H, P)
    h = torch.zeros(Bsz, H, P, S) if h0 is None else h0.clone()
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        cum = torch.cumsum(dtf[:, sl] * A, 1)  # [B, Q, H]
        w = torch.exp(cum[:, -1:] - cum) * dtf[:, sl]
        xw = split(xf[:, sl] * w[..., None], parts["xw"])
        states = torch.einsum("bqhp,bqhs->bhps", xw, Bf[:, sl])
        y_off = torch.einsum("bqhs,bhps->bqhp", Cf[:, sl], split(h, parts["h_in"]))
        ct = cum.permute(0, 2, 1)
        d = ct[..., :, None] - ct[..., None, :]
        CB = torch.einsum("bqhs,bkhs->bhqk", Cf[:, sl], Bf[:, sl])
        M = torch.where(tri, CB * torch.exp(torch.where(tri, d, 0.0))
                        * dtf[:, sl].permute(0, 2, 1)[:, :, None, :], 0.0)
        y[:, sl] = (torch.einsum("bhqk,bkhp->bqhp", split(M, parts["M"]), xf[:, sl])
                    + y_off * torch.exp(cum)[..., None])
        h = h * torch.exp(cum[:, -1])[..., None, None] + states
    return y[:, :L].to(x.dtype), h


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8])
    ap.add_argument("--chunk", type=int, default=ssk.CHUNK)
    args = ap.parse_args()
    torch.set_num_threads(4)
    B, L, H, P, G, S = 1, 2000, args.heads, 64, 1, 128
    for seed in args.seeds:
        rng = np.random.default_rng(seed)

        def t(a, dtype=torch.bfloat16):
            return torch.from_numpy(a.astype(np.float32)).to(dtype)

        x = t(rng.standard_normal((B, L, H, P)))
        dt = t(np.abs(rng.standard_normal((B, L, H))) * 0.1, torch.float32)
        A = t(-np.abs(rng.standard_normal(H)) - 0.1, torch.float32)
        Bm, Cm = t(rng.standard_normal((B, L, G, S))), t(rng.standard_normal((B, L, G, S)))
        h0 = t(rng.standard_normal((B, H, P, S)) * 0.1, torch.float32)
        yp, hp = ssk.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=256, initial_state=h0)
        exact = ref.ssd_scan_ref(*(v.double() for v in (x, dt, A, Bm, Cm)),
                                 initial_state=h0.double())
        p64 = (hp.double() - exact[1]).abs().max().item()
        for n in (2, 3):
            y, hT = emulate(x, dt, A, Bm, Cm, h0, args.chunk, {"xw": n, "h_in": n, "M": n})
            over = ((y.float() - yp.float()).abs() - yp.float().abs() * 2.0**-7).max().item()
            k64 = (hT.double() - exact[1]).abs().max().item()
            print(f"seed {seed}, chunk {args.chunk}, {n} parts: y past one bf16 ulp by "
                  f"{max(over, 0.0):.2e} (gate 5e-05); final state from the f64 scan "
                  f"{k64:.2e} (plain {p64:.2e}; gate max(5e-05, plain))", flush=True)


if __name__ == "__main__":
    main()
