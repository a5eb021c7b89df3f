"""Shape-only stand-ins for every (arch x shape) cell of the matrix.

The reference's ``configs/shapes.py``: ``input_specs(cfg, shape)`` returns a
:class:`CellSpec` naming the step a cell runs (``train``, ``prefill`` or
``decode``) and its batch as ``meta`` tensors, the shapes and dtypes of the
reference's ``ShapeDtypeStruct`` stand-ins with nothing allocated.  A
prefill or decode cell's ``state`` is the model's ``init_state`` on
``meta`` (the reference's ``jax.eval_shape`` over it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec, cell_is_runnable
from repro_torch.models import registry
from repro_torch.models.common import resolve_dtype

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class CellSpec:
    arch: str
    shape: str
    kind: str  # "train" | "prefill" | "decode"
    batch: Dict[str, Any]  # the step's keyword inputs (no params), as meta tensors


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _state_spec(cfg: ArchConfig, batch: int, max_len: int, enc_len=None):
    api = registry.get_model(cfg)
    if cfg.family == "encdec":
        return api.init_state(cfg, batch, max_len, device=META, enc_len=enc_len)
    return api.init_state(cfg, batch, max_len, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> CellSpec:
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        raise ValueError(f"cell {cfg.name} x {shape.name} is skipped: {why}")

    gb, S = shape.global_batch, shape.seq_len
    act = resolve_dtype(cfg.dtype)
    i32, f32 = torch.int32, torch.float32

    if shape.kind == "train":
        if cfg.family == "encdec":
            dl = cfg.decoder_seq_len
            batch = {
                "frames": _meta((gb, S, cfg.d_model), act),
                "dec_tokens": _meta((gb, dl), i32),
                "labels": _meta((gb, dl), i32),
                "mask": _meta((gb, dl), f32),
            }
        elif cfg.family == "vlm":
            ft = cfg.frontend_tokens
            batch = {
                "tokens": _meta((gb, S - ft), i32),
                "embeds": _meta((gb, ft, cfg.d_model), act),
                "labels": _meta((gb, S), i32),
                "mask": _meta((gb, S), f32),
            }
        else:
            batch = {
                "tokens": _meta((gb, S), i32),
                "labels": _meta((gb, S), i32),
                "mask": _meta((gb, S), f32),
            }
        return CellSpec(cfg.name, shape.name, "train", batch)

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            # the context is S audio frames (encoded now, their cross K/V
            # written to the state); the decoder's whole prompt window
            dl = cfg.decoder_seq_len
            batch = {
                "tokens": _meta((gb, dl), i32),
                "embeds": _meta((gb, S, cfg.d_model), act),
                "state": _state_spec(cfg, gb, dl, enc_len=S),
            }
        elif cfg.family == "vlm":
            ft = cfg.frontend_tokens
            batch = {
                "tokens": _meta((gb, S - ft), i32),
                "embeds": _meta((gb, ft, cfg.d_model), act),
                "state": _state_spec(cfg, gb, S),
            }
        else:
            batch = {
                "tokens": _meta((gb, S), i32),
                "state": _state_spec(cfg, gb, S),
            }
        return CellSpec(cfg.name, shape.name, "prefill", batch)

    # decode: one new token against a cache of S context tokens
    if cfg.family == "encdec":
        state = _state_spec(cfg, gb, S, enc_len=cfg.encoder_seq_len)
    else:
        state = _state_spec(cfg, gb, S)
    batch = {"tokens": _meta((gb, 1), i32), "state": state}
    return CellSpec(cfg.name, shape.name, "decode", batch)
