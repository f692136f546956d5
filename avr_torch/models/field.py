"""Neural impulse-response fields (port of ``avr_tpu/models/field.py``).

Two variants, as in the JAX package:

  * ``standard`` (MeshRIR, Simu, Real_env): hash encodings of position,
    view direction and transmitter position; a sigma encoder (→128) and
    decoder (→1 attenuation); a signal network over concat(sigma_feat,
    dir_enc, tx_enc). Each subnet may be conditioned on the microphone
    channel: "add" puts a per-layer embedding row into its hidden layers
    (``mlp`` injection), "concat" appends an embedding row
    (``params["concat_emb"]``) to its input.
  * ``complex`` (RAF): six encodings (pos/tx-pos for sigma, pos/tx-pos for
    signal, view dir, tx dir), a 256-wide sigma feature, and a signal
    network over five concatenated parts. When the pos and pos_sig
    encodings share one geometry, their tables are stored as one fused
    ``[E_pad, 2F]`` parameter ``enc.pos_pair``: one gather forward and one
    scatter-add backward for both.

``apply`` is the full query, concatenating the parts per point as the
reference does (the oracle path). The factored query API
(``sigma_query``, ``signal_context``, ``point_features``,
``signal_tail_from_features``, ``signal_from_parts``) is what the fused
renderer calls: direction, transmitter and channel parts are computed once
per ray / per batch element and folded into the first matmul of the signal
network.

All inputs are [−1,1] box coordinates, mapped to the unit cube with
(x+1)/2.

Population training: every leaf of ``params`` may carry a leading trial
axis K (``n_trials``). The query points, directions and channels stay
shared, and every output then carries the leading K.
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


SIGMA_FEAT_STANDARD = 128  # reference/model.py:99,119
SIGMA_FEAT_COMPLEX = 256  # reference/model.py:269


@dataclass(frozen=True)
class FieldStatic:
    variant: str  # "standard" | "complex"
    signal_output_dim: int
    leaky_slope: float
    encodings: Dict[str, EncStatic]
    sigma_encoder: mlp.MLPStatic
    sigma_decoder: mlp.MLPStatic
    signal: mlp.MLPStatic
    # channel conditioning per subnet: "none" | "add" | "concat"
    enc_mode: str = "none"
    dec_mode: str = "none"
    sig_mode: str = "none"
    ch_num: int = 0
    emb_dim_enc: int = 0
    emb_dim_dec: int = 0
    emb_dim_sig: int = 0

    @property
    def sigma_feat_dim(self) -> int:
        return self.sigma_encoder.n_output_dims


def build_field(cfg: ModelConfig, dataset_type: str = "MeshRIR") -> FieldStatic:
    """Map a ModelConfig to a FieldStatic: RAF uses the complex variant,
    every other dataset the standard one."""
    if dataset_type == "RAF":
        return _build_complex(cfg)
    return _build_standard(cfg)


def _mlp_static(cfg, n_in, n_out, inject=False, ch_num=0) -> mlp.MLPStatic:
    return mlp.MLPStatic(
        n_input_dims=n_in,
        n_output_dims=n_out,
        n_neurons=cfg.n_neurons,
        n_hidden_layers=cfg.n_hidden_layers,
        activation=cfg.activation,
        output_activation=cfg.output_activation,
        use_bias=cfg.use_bias,
        inject=inject,
        ch_num=ch_num,
    )


def _build_standard(cfg: ModelConfig) -> FieldStatic:
    enc = {
        "pos": _enc_static(cfg.pos_encoding_sigma),
        "dir": _enc_static(cfg.dir_encoding_sig),
        "tx": _enc_static(cfg.tx_encoding_sig),
    }
    ch = cfg.channel_embed
    mode = ch.connection_type if ch.is_embed else "none"
    enc_mode = mode if (ch.is_embed and ch.is_sigma_encoder) else "none"
    dec_mode = mode if (ch.is_embed and ch.is_sigma_decoder) else "none"
    sig_mode = mode if (ch.is_embed and ch.is_signal_network) else "none"
    d_enc = ch.emb_dim_sigma_encoder if enc_mode == "concat" else 0
    d_dec = ch.emb_dim_sigma_decoder if dec_mode == "concat" else 0
    d_sig = ch.emb_dim_signal_network if sig_mode == "concat" else 0
    sig_in = SIGMA_FEAT_STANDARD + enc["dir"].n_output_dims + enc["tx"].n_output_dims + d_sig
    return FieldStatic(
        variant="standard",
        signal_output_dim=cfg.signal_output_dim,
        # the reference's standard model uses leaky_relu's default slope and
        # ignores the YAML value (reference/model.py:233)
        leaky_slope=0.01,
        encodings=enc,
        sigma_encoder=_mlp_static(
            cfg.sigma_encoder_network, enc["pos"].n_output_dims + d_enc, SIGMA_FEAT_STANDARD,
            inject=enc_mode == "add", ch_num=ch.ch_num,
        ),
        sigma_decoder=_mlp_static(
            cfg.sigma_decoder_network, SIGMA_FEAT_STANDARD + d_dec, 1,
            inject=dec_mode == "add", ch_num=ch.ch_num,
        ),
        signal=_mlp_static(
            cfg.signal_network, sig_in, cfg.signal_output_dim,
            inject=sig_mode == "add", ch_num=ch.ch_num,
        ),
        enc_mode=enc_mode,
        dec_mode=dec_mode,
        sig_mode=sig_mode,
        ch_num=ch.ch_num,
        emb_dim_enc=d_enc,
        emb_dim_dec=d_dec,
        emb_dim_sig=d_sig,
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
    a, b = static.encodings.get("pos"), static.encodings.get("pos_sig")
    return b is not None and a.otype == "hashgrid" and a == b


def init(generator: Optional[torch.Generator], static: FieldStatic, device="cuda") -> Dict:
    """Random params with the JAX package's distributions: tables
    U(±1e−4), He-normal weights, zero biases, channel embeddings
    N(0, 1/width). Same tree and shapes as ``avr_tpu.models.field.init``."""
    device = resolve_device(device)
    gdev = generator.device if generator is not None else device
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
    for name, mode, dim in (
        ("enc", static.enc_mode, static.emb_dim_enc),
        ("dec", static.dec_mode, static.emb_dim_dec),
        ("sig", static.sig_mode, static.emb_dim_sig),
    ):
        if mode == "concat" and dim > 0:
            e = torch.randn((static.ch_num, dim), generator=generator, device=gdev)
            params["concat_emb"][name] = e.to(device) / dim**0.5
    return params


def n_trials(params: Dict) -> int:
    """K for params stacked over K trials (population training), else 0."""
    w0 = params["sigma_encoder"]["w"][0]
    return w0.shape[0] if w0.dim() == 3 else 0


def _enc(params: Dict, static: FieldStatic, name: str, x01: torch.Tensor, compute_dtype=None):
    if name in ("pos", "pos_sig") and "pos_pair" in params["enc"]:
        a, b = hashgrid.encode_pair_fused(
            params["enc"]["pos_pair"], static.encodings["pos"].grid, x01,
            compute_dtype=compute_dtype,
        )
        return a if name == "pos" else b
    st = static.encodings[name]
    out = _enc_apply(params["enc"].get(name), st, x01, compute_dtype=compute_dtype)
    K = n_trials(params)
    if K and st.otype != "hashgrid":  # a parameter-free encoding, the same for every trial
        out = out.expand(K, *out.shape)
    return out


def _to01(x: torch.Tensor) -> torch.Tensor:
    return (x + 1.0) / 2.0


def _attn(raw: torch.Tensor, static: FieldStatic) -> torch.Tensor:
    return torch.abs(Fn.leaky_relu(raw, static.leaky_slope))


def _if_add(mode: str, ch_idx):
    """The channels for an ``add``-injected subnet, else None."""
    return ch_idx if mode == "add" else None


def _concat_emb(params, name: str, ch_idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The concat embedding rows of ``ch_idx``, broadcast to like's leading dims."""
    emb = mlp.rows(params["concat_emb"][name], ch_idx)  # [(K,) ..., dim]
    return emb.expand(*like.shape[:-1], emb.shape[-1])


def _signal_dims(static: FieldStatic):
    """Row counts of the signal network's input parts, in concat order."""
    if static.variant == "complex":
        return [
            SIGMA_FEAT_COMPLEX,
            static.encodings["dir"].n_output_dims,
            static.encodings["tx_dir"].n_output_dims,
            static.encodings["pos_sig"].n_output_dims,
            static.encodings["tx_pos_sig"].n_output_dims,
        ]
    return [
        SIGMA_FEAT_STANDARD,
        static.encodings["dir"].n_output_dims,
        static.encodings["tx"].n_output_dims,
    ] + ([static.emb_dim_sig] if static.sig_mode == "concat" else [])


def _sigma_branch(params, static, pos_enc, tx_pos_enc, compute_dtype):
    """Complex sigma encoder with its input folded per part, then the
    decoder. The tx part stays at its own (broadcastable) granularity: each
    row's product is the same as after broadcasting, at a fraction of the work."""
    w_pos, w_tx = mlp.input_weight_slices(
        params["sigma_encoder"], [pos_enc.shape[-1], tx_pos_enc.shape[-1]]
    )
    h = mlp._matmul(pos_enc, w_pos, compute_dtype) + mlp._matmul(tx_pos_enc, w_tx, compute_dtype)
    sigma_feat = mlp.apply_tail(
        params["sigma_encoder"], static.sigma_encoder, h, compute_dtype=compute_dtype, add_first_bias=True
    )
    raw = mlp.apply(
        params["sigma_decoder"], static.sigma_decoder, torch.relu(sigma_feat),
        compute_dtype=compute_dtype,
    )
    return sigma_feat, _attn(raw, static)


def _sigma_standard(params, static, pos_enc, ch_idx, compute_dtype):
    """Standard sigma encoder and decoder, with their channel conditioning."""
    enc_in = pos_enc
    if static.enc_mode == "concat" and ch_idx is not None:
        enc_in = torch.cat([enc_in, _concat_emb(params, "enc", ch_idx, pos_enc)], dim=-1)
    sigma_feat = mlp.apply(
        params["sigma_encoder"], static.sigma_encoder, enc_in,
        ch_idx=_if_add(static.enc_mode, ch_idx), compute_dtype=compute_dtype,
    )
    dec_in = torch.relu(sigma_feat)
    if static.dec_mode == "concat" and ch_idx is not None:
        dec_in = torch.cat([dec_in, _concat_emb(params, "dec", ch_idx, dec_in)], dim=-1)
    raw = mlp.apply(
        params["sigma_decoder"], static.sigma_decoder, dec_in,
        ch_idx=_if_add(static.dec_mode, ch_idx), compute_dtype=compute_dtype,
    )
    return sigma_feat, _attn(raw, static)


# ----------------------------------------------------------------------
# Full (unfactored) query: the oracle path
# ----------------------------------------------------------------------
def apply(
    params: Dict, static: FieldStatic, pts: torch.Tensor, view: torch.Tensor, tx: torch.Tensor,
    tx_view: Optional[torch.Tensor] = None, ch_idx: Optional[torch.Tensor] = None,
    compute_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query the field at points.

    pts/view/tx[/tx_view]: [..., 3] in [−1,1]; ch_idx: [...] integer or None.
    Returns (attn [..., 1], signal [..., signal_output_dim]).
    """
    if static.variant == "complex":
        return _apply_complex(params, static, pts, view, tx, tx_view, compute_dtype)
    pos_enc = _enc(params, static, "pos", _to01(pts))
    sigma_feat, attn = _sigma_standard(params, static, pos_enc, ch_idx, compute_dtype)
    sig_in = torch.cat(
        [sigma_feat, _enc(params, static, "dir", _to01(view)), _enc(params, static, "tx", _to01(tx))],
        dim=-1,
    )
    if static.sig_mode == "concat" and ch_idx is not None:
        sig_in = torch.cat([sig_in, _concat_emb(params, "sig", ch_idx, sig_in)], dim=-1)
    signal = mlp.apply(
        params["signal"], static.signal, sig_in,
        ch_idx=_if_add(static.sig_mode, ch_idx), compute_dtype=compute_dtype,
    )
    return attn, signal


def _apply_complex(params, static, pts, view, tx, tx_view, compute_dtype):
    if tx_view is None:
        raise ValueError("complex field variant requires tx_view")
    p01, v01, t01, tv01 = _to01(pts), _to01(view), _to01(tx), _to01(tx_view)
    sigma_feat = mlp.apply(
        params["sigma_encoder"], static.sigma_encoder,
        torch.cat([_enc(params, static, "pos", p01), _enc(params, static, "tx_pos", t01)], dim=-1),
        compute_dtype=compute_dtype,
    )
    raw = mlp.apply(
        params["sigma_decoder"], static.sigma_decoder, torch.relu(sigma_feat),
        compute_dtype=compute_dtype,
    )
    sig_in = torch.cat(
        [
            torch.relu(sigma_feat),
            _enc(params, static, "dir", v01),
            _enc(params, static, "tx_dir", tv01),
            _enc(params, static, "pos_sig", p01),
            _enc(params, static, "tx_pos_sig", t01),
        ],
        dim=-1,
    )
    signal = mlp.apply(params["signal"], static.signal, sig_in, compute_dtype=compute_dtype)
    return _attn(raw, static), signal


# ----------------------------------------------------------------------
# Factored query API: what the fused renderer calls
# ----------------------------------------------------------------------
def sigma_query(
    params: Dict, static: FieldStatic, pts: torch.Tensor, tx: Optional[torch.Tensor] = None,
    ch_idx: Optional[torch.Tensor] = None, compute_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point sigma branch: (sigma_feat [..., 128 or 256], attn [..., 1]).

    ``tx`` ([..., 3], broadcastable against pts' leading dims) is read by
    the complex variant, ``ch_idx`` (broadcastable likewise) by the
    standard one.
    """
    pos_enc = _enc(params, static, "pos", _to01(pts), compute_dtype=compute_dtype)
    if static.variant == "complex":
        tx_pos_enc = _enc(params, static, "tx_pos", _to01(tx))
        return _sigma_branch(params, static, pos_enc, tx_pos_enc, compute_dtype)
    return _sigma_standard(params, static, pos_enc, ch_idx, compute_dtype)


def signal_context(
    params: Dict, static: FieldStatic, dirs: torch.Tensor, tx: torch.Tensor,
    tx_view: Optional[torch.Tensor] = None, ch_idx: Optional[torch.Tensor] = None,
    compute_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray and per-batch first-layer contributions of the signal network.

    dirs [R, 3] (view = −dir), tx [B, 3] normalized, tx_view [B, 3]
    (complex), ch_idx [B] (standard, concat mode: its embedding's part is
    folded here once per batch element). Returns (h_ray [R, W],
    h_batch [B, W]), each with a leading K for K trials' params; the bias
    is folded into h_batch.
    """
    slices = mlp.input_weight_slices(params["signal"], _signal_dims(static))
    dir_enc = _enc(params, static, "dir", _to01(-dirs))
    h_ray = mlp._matmul(dir_enc, slices[1], compute_dtype)
    if static.variant == "complex":
        txd_enc = _enc(params, static, "tx_dir", _to01(tx_view))
        tsig_enc = _enc(params, static, "tx_pos_sig", _to01(tx))
        h_batch = mlp._matmul(txd_enc, slices[2], compute_dtype) + mlp._matmul(
            tsig_enc, slices[4], compute_dtype
        )
    else:
        h_batch = mlp._matmul(_enc(params, static, "tx", _to01(tx)), slices[2], compute_dtype)
        if static.sig_mode == "concat" and ch_idx is not None:
            emb = mlp.rows(params["concat_emb"]["sig"], ch_idx)  # [(K,) B, dim]
            h_batch = h_batch + mlp._matmul(emb, slices[3], compute_dtype)
    if static.signal.use_bias:
        h_batch = h_batch + mlp.per_trial(params["signal"]["b"][0], h_batch)
    return h_ray, h_batch


def point_features(
    params: Dict, static: FieldStatic, pts: torch.Tensor, tx: Optional[torch.Tensor] = None,
    ch_idx: Optional[torch.Tensor] = None, compute_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Every per-point quantity the signal tail needs, in one pass:
    (sigma_feat [..., D], attn [..., 1], psig_enc [..., E] for the complex
    variant, else None).

    Each hash table sees one gather forward and one scatter-add backward.
    """
    if static.variant != "complex":
        sigma_feat, attn = sigma_query(
            params, static, pts, ch_idx=ch_idx, compute_dtype=compute_dtype
        )
        return sigma_feat, attn, None
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
    params: Dict, static: FieldStatic, sigma_feat: torch.Tensor, psig_enc: Optional[torch.Tensor],
    context: Tuple[torch.Tensor, torch.Tensor], ch_idx: Optional[torch.Tensor] = None, compute_dtype=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Signal network given precomputed per-point features (no gathers).

    The complex variant takes relu(sigma_feat) and psig_enc; the standard
    one the raw sigma_feat, and ch_idx for "add" injection. ``context`` is
    ``signal_context``'s pair (h_ray [(K,) R, W], h_batch [(K,) B, W]) for
    features [(K,) B, R, C, ...], added in the first layer without forming
    their [(K,) B, R, 1, W] sum (``mlp.apply_parts``). Returns ``mlp.apply_tail``'s pair (signal
    [..., signal_output_dim] before the output layer's bias, that bias), or
    (signal, None) where the output activation is not the identity: the
    signal is the pair's sum, as ``ops.signal_contract`` adds it.
    """
    slices = mlp.input_weight_slices(params["signal"], _signal_dims(static))
    if static.variant == "complex":
        parts = [(torch.relu(sigma_feat), slices[0]), (psig_enc, slices[3])]
        ch_idx = None
    else:
        parts = [(sigma_feat, slices[0])]
        ch_idx = _if_add(static.sig_mode, ch_idx)
    return mlp.apply_parts(
        params["signal"], static.signal, parts, context, ch_idx=ch_idx, compute_dtype=compute_dtype,
        split_bias=True,
    )


def signal_from_parts(
    params: Dict, static: FieldStatic, sigma_feat: torch.Tensor, pts: Optional[torch.Tensor],
    context: Tuple[torch.Tensor, torch.Tensor], ch_idx: Optional[torch.Tensor] = None, compute_dtype=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-point signal given the factored first-layer context, for the
    streaming plan: as ``signal_tail_from_features``, with the complex
    variant's pos_sig encoding of pts ([..., 3] in [−1,1]) computed here,
    in fp32 as the JAX package does. Returns the same pair."""
    psig_enc = (
        _enc(params, static, "pos_sig", _to01(pts)) if static.variant == "complex" else None
    )
    return signal_tail_from_features(
        params, static, sigma_feat, psig_enc, context, ch_idx=ch_idx, compute_dtype=compute_dtype
    )
