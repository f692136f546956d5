"""Neural impulse-response field, complex (RAF) variant.

Port of ``avr_tpu/models/field.py``: six encodings (pos/tx-pos for sigma,
pos/tx-pos for signal, view dir, tx dir), a 256-wide sigma feature, and a
signal network over five concatenated parts. When the pos and pos_sig
encodings share one geometry, their tables are stored as one fused
``[E_pad, 2F]`` parameter ``enc.pos_pair``: one gather forward and one
scatter-add backward for both.

The factored query API (``signal_context``, ``point_features``,
``signal_tail_from_features``) is what the fused renderer calls: direction
and transmitter encodings are computed once per ray / per batch element
and folded into the first matmul of the signal network.

All inputs are [−1,1] box coordinates, mapped to the unit cube with
(x+1)/2. The standard variant and channel embeddings are a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn

from avr_torch.config import EncodingConfig, ModelConfig
from avr_torch.device import resolve_device
from avr_torch.models import hashgrid, mlp


@dataclass(frozen=True)
class EncStatic:
    otype: str
    grid: Optional[hashgrid.HashGridStatic]
    n_frequencies: int
    n_output_dims: int


def _enc_static(cfg: EncodingConfig) -> EncStatic:
    ot = cfg.otype.lower()
    if ot in ("hashgrid", "grid", "densegrid"):
        g = hashgrid.build_static(cfg)
        return EncStatic("hashgrid", g, 0, g.n_output_dims)
    if ot == "frequency":
        return EncStatic("frequency", None, cfg.n_frequencies, 6 * cfg.n_frequencies)
    if ot == "identity":
        return EncStatic("identity", None, 0, 3)
    raise ValueError(f"unsupported encoding otype {cfg.otype!r}")


def _enc_apply(param, st: EncStatic, x01: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    if st.otype == "hashgrid":
        return hashgrid.encode(param, st.grid, x01, compute_dtype=compute_dtype)
    if st.otype == "frequency":
        return hashgrid.frequency_encode(x01, st.n_frequencies)
    return x01


SIGMA_FEAT_COMPLEX = 256  # reference/model.py:269


@dataclass(frozen=True)
class FieldStatic:
    variant: str  # "complex" (the standard variant is not ported yet)
    signal_output_dim: int
    leaky_slope: float
    encodings: Dict[str, EncStatic]
    sigma_encoder: mlp.MLPStatic
    sigma_decoder: mlp.MLPStatic
    signal: mlp.MLPStatic


def build_field(cfg: ModelConfig, dataset_type: str = "RAF") -> FieldStatic:
    """Map a ModelConfig to a FieldStatic. RAF uses the complex variant."""
    if dataset_type != "RAF":
        raise NotImplementedError(
            f"dataset_type {dataset_type!r} needs the standard field variant, "
            "which avr_torch does not port yet (ROADMAP queue 1)"
        )
    return _build_complex(cfg)


def _mlp_static(cfg, n_in, n_out) -> mlp.MLPStatic:
    return mlp.MLPStatic(
        n_input_dims=n_in,
        n_output_dims=n_out,
        n_neurons=cfg.n_neurons,
        n_hidden_layers=cfg.n_hidden_layers,
        activation=cfg.activation,
        output_activation=cfg.output_activation,
        use_bias=cfg.use_bias,
    )


def _build_complex(cfg: ModelConfig) -> FieldStatic:
    def enc_or_default(c: Optional[EncodingConfig]) -> EncStatic:
        return _enc_static(c if c is not None else EncodingConfig())

    enc = {
        "pos": enc_or_default(cfg.pos_encoding_sigma),
        "tx_pos": enc_or_default(cfg.tx_pos_encoding_sigma),
        "pos_sig": enc_or_default(cfg.pos_encoding_sig),
        "tx_pos_sig": enc_or_default(cfg.tx_pos_encoding_sig),
        "dir": enc_or_default(cfg.dir_encoding_sig),
        "tx_dir": enc_or_default(cfg.tx_dir_encoding_sig),
    }
    enc_in = enc["pos"].n_output_dims + enc["tx_pos"].n_output_dims
    sig_in = (
        SIGMA_FEAT_COMPLEX
        + enc["dir"].n_output_dims
        + enc["tx_dir"].n_output_dims
        + enc["pos_sig"].n_output_dims
        + enc["tx_pos_sig"].n_output_dims
    )
    return FieldStatic(
        variant="complex",
        signal_output_dim=cfg.signal_output_dim,
        leaky_slope=float(cfg.leaky_relu),
        encodings=enc,
        sigma_encoder=_mlp_static(cfg.sigma_encoder_network, enc_in, SIGMA_FEAT_COMPLEX),
        sigma_decoder=_mlp_static(cfg.sigma_decoder_network, SIGMA_FEAT_COMPLEX, 1),
        signal=_mlp_static(cfg.signal_network, sig_in, cfg.signal_output_dim),
    )


def _paired_pos(static: FieldStatic) -> bool:
    """True when pos & pos_sig encodings can share one fused table."""
    a, b = static.encodings["pos"], static.encodings["pos_sig"]
    return a.otype == "hashgrid" and a == b


def init(generator: Optional[torch.Generator], static: FieldStatic, device="cuda") -> Dict:
    """Random params with the JAX package's distributions: tables
    U(±1e−4), He-normal weights, zero biases. Same tree and shapes as
    ``avr_tpu.models.field.init``."""
    device = resolve_device(device)
    params: Dict = {"enc": {}, "concat_emb": {}}
    paired = _paired_pos(static)
    for name, st in sorted(static.encodings.items()):
        if st.otype != "hashgrid" or (paired and name == "pos_sig"):
            continue
        if paired and name == "pos":
            params["enc"]["pos_pair"] = hashgrid.init(
                generator, st.grid, device, width=2 * st.grid.n_features
            )
        else:
            params["enc"][name] = hashgrid.init(generator, st.grid, device)
    params["sigma_encoder"] = mlp.init(generator, static.sigma_encoder, device)
    params["sigma_decoder"] = mlp.init(generator, static.sigma_decoder, device)
    params["signal"] = mlp.init(generator, static.signal, device)
    return params


def _enc(params: Dict, static: FieldStatic, name: str, x01: torch.Tensor, compute_dtype=None):
    if name in ("pos", "pos_sig") and "pos_pair" in params["enc"]:
        a, b = hashgrid.encode_pair_fused(
            params["enc"]["pos_pair"], static.encodings["pos"].grid, x01,
            compute_dtype=compute_dtype,
        )
        return a if name == "pos" else b
    return _enc_apply(
        params["enc"].get(name), static.encodings[name], x01, compute_dtype=compute_dtype
    )


def _to01(x: torch.Tensor) -> torch.Tensor:
    return (x + 1.0) / 2.0


def _attn(raw: torch.Tensor, static: FieldStatic) -> torch.Tensor:
    return torch.abs(Fn.leaky_relu(raw, static.leaky_slope))


def _signal_dims(static: FieldStatic):
    return [
        SIGMA_FEAT_COMPLEX,
        static.encodings["dir"].n_output_dims,
        static.encodings["tx_dir"].n_output_dims,
        static.encodings["pos_sig"].n_output_dims,
        static.encodings["tx_pos_sig"].n_output_dims,
    ]


def _sigma_branch(params, static, pos_enc, tx_pos_enc, compute_dtype):
    """Sigma encoder with its input folded per part, then the decoder. The
    tx part stays at its own (broadcastable) granularity: each row's
    product is the same as after broadcasting, at a fraction of the work."""
    w_pos, w_tx = mlp.input_weight_slices(
        params["sigma_encoder"], [pos_enc.shape[-1], tx_pos_enc.shape[-1]]
    )
    h = mlp._matmul(pos_enc, w_pos, compute_dtype) + mlp._matmul(tx_pos_enc, w_tx, compute_dtype)
    if static.sigma_encoder.use_bias:
        h = h + params["sigma_encoder"]["b"][0]
    sigma_feat = mlp.apply_tail(
        params["sigma_encoder"], static.sigma_encoder, h, compute_dtype=compute_dtype
    )
    raw = mlp.apply(
        params["sigma_decoder"], static.sigma_decoder, torch.relu(sigma_feat),
        compute_dtype=compute_dtype,
    )
    return sigma_feat, _attn(raw, static)


def sigma_query(
    params: Dict, static: FieldStatic, pts: torch.Tensor, tx: torch.Tensor, compute_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point sigma branch: (sigma_feat [..., 256], attn [..., 1])."""
    pos_enc = _enc(params, static, "pos", _to01(pts), compute_dtype=compute_dtype)
    tx_pos_enc = _enc(params, static, "tx_pos", _to01(tx))
    return _sigma_branch(params, static, pos_enc, tx_pos_enc, compute_dtype)


def signal_context(
    params: Dict, static: FieldStatic, dirs: torch.Tensor, tx: torch.Tensor,
    tx_view: torch.Tensor, compute_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray and per-batch first-layer contributions of the signal network.

    dirs [R, 3] (view = −dir), tx [B, 3] normalized, tx_view [B, 3].
    Returns (h_ray [R, W], h_batch [B, W]); the bias is folded into h_batch.
    """
    _, w_dir, w_txd, _, w_tsig = mlp.input_weight_slices(params["signal"], _signal_dims(static))
    dir_enc = _enc(params, static, "dir", _to01(-dirs))
    txd_enc = _enc(params, static, "tx_dir", _to01(tx_view))
    tsig_enc = _enc(params, static, "tx_pos_sig", _to01(tx))
    h_ray = mlp._matmul(dir_enc, w_dir, compute_dtype)
    h_batch = mlp._matmul(txd_enc, w_txd, compute_dtype) + mlp._matmul(
        tsig_enc, w_tsig, compute_dtype
    )
    if static.signal.use_bias:
        h_batch = h_batch + params["signal"]["b"][0]
    return h_ray, h_batch


def point_features(
    params: Dict, static: FieldStatic, pts: torch.Tensor, tx: torch.Tensor, compute_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every per-point quantity the signal tail needs, in one pass:
    (sigma_feat [..., 256], attn [..., 1], psig_enc [..., E]).

    Each hash table sees one gather forward and one scatter-add backward.
    """
    if _paired_pos(static) and "pos_pair" in params["enc"]:
        pos_enc, psig_enc = hashgrid.encode_pair_fused(
            params["enc"]["pos_pair"], static.encodings["pos"].grid, _to01(pts),
            compute_dtype=compute_dtype,
        )
    else:
        pos_enc = _enc(params, static, "pos", _to01(pts), compute_dtype=compute_dtype)
        psig_enc = _enc(params, static, "pos_sig", _to01(pts), compute_dtype=compute_dtype)
    tx_pos_enc = _enc(params, static, "tx_pos", _to01(tx))
    sigma_feat, attn = _sigma_branch(params, static, pos_enc, tx_pos_enc, compute_dtype)
    return sigma_feat, attn, psig_enc


def signal_tail_from_features(
    params: Dict, static: FieldStatic, sigma_feat: torch.Tensor, psig_enc: torch.Tensor,
    h_extra: torch.Tensor, compute_dtype=None,
) -> torch.Tensor:
    """Signal network given precomputed per-point features (no gathers)."""
    slices = mlp.input_weight_slices(params["signal"], _signal_dims(static))
    h = (
        mlp._matmul(torch.relu(sigma_feat), slices[0], compute_dtype)
        + mlp._matmul(psig_enc, slices[3], compute_dtype)
        + h_extra
    )
    return mlp.apply_tail(params["signal"], static.signal, h, compute_dtype=compute_dtype)
