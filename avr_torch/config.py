"""Typed configuration for avr_tpu.

YAML-compatible with the reference config schema: four sections
``path`` / ``render`` / ``train`` / ``model`` (reference/avr_runner.py:27-31,
canonical example reference/config_files/avr_meshrir.yml), so every reference
YAML loads unchanged. Unknown keys are preserved in ``extra`` dicts rather
than rejected, because the reference's Optuna tooling injects ad-hoc keys.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import yaml


def _as_xyz(v: Union[float, int, Sequence[float]]) -> List[float]:
    """Broadcast a scalar bound to a 3-vector (reference stores scalars)."""
    if isinstance(v, (int, float)):
        return [float(v)] * 3
    out = [float(x) for x in v]
    if len(out) != 3:
        raise ValueError(f"xyz bound must be scalar or length-3, got {v!r}")
    return out


@dataclass
class PathConfig:
    expname: str = "avr_tpu"
    dataset_type: str = "MeshRIR"
    logdir: str = "logs/avr_tpu"
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RenderConfig:
    """Spherical volume-rendering geometry (reference/renderer.py:16-29)."""

    xyz_min: List[float] = field(default_factory=lambda: [-6.0] * 3)
    xyz_max: List[float] = field(default_factory=lambda: [6.0] * 3)
    near: float = 0.0
    far: float = 4.0
    n_samples: int = 64
    n_azi: int = 80
    n_ele: int = 40
    speed: float = 343.8
    fs: int = 24000
    pathloss: float = 1.5
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_rays(self) -> int:
        # n_azi*n_ele grid directions plus the two poles
        # (reference/renderer.py:157-164).
        return self.n_azi * self.n_ele + 2


@dataclass
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 0.0
    T_max: int = 200_000
    eta_min: float = 1e-4
    total_iterations: int = 200_000
    load_ckpt: bool = False
    save_freq: int = 20_000
    val_freq: int = 20_000
    batch_size: int = 4

    # Loss weights (reference/utils/criterion.py:11-21).
    spec_loss_weight: float = 1.0
    amplitude_loss_weight: float = 0.5
    angle_loss_weight: float = 0.5
    time_loss_weight: float = 100.0
    energy_loss_weight: float = 5.0
    multistft_loss_weight: float = 1.0
    das_reg_loss_weight: float = 0.0
    das_ce_loss_weight: float = 0.0
    beta: float = 100.0  # soft-argmax sharpness for the DAS regression loss

    # TPU-specific knobs (no reference equivalent).
    compute_dtype: str = "bfloat16"  # matmul compute dtype for field queries
    shell_chunk: int = 1  # sample shells rendered per scan step
    # Above this many points (bs·rays·samples) the renderer streams the
    # field queries shell-chunk-wise instead of precomputing them all
    # (render/fused.py point_budget) — caps peak memory on heavy shapes
    # like the reference MeshRIR config (820k points/step at batch 4).
    point_budget: int = 4_000_000
    # rematerialization of the render scan bodies in the backward pass:
    # True/"full", False/"none", or a jax.checkpoint_policies name
    # ("dots", "dots_nb") — see render/fused.py:_remat_wrap
    remat: Any = True
    steps_per_call: int = 1  # optimizer steps folded into one dispatch (scan)
    # per-sample metric_cal cap during validation (host-side numpy);
    # 0 = evaluate every rendered sample
    val_metric_cap: int = 256
    # pass lr/eta_min/T_max/weight_decay/loss weights as RUNTIME scalars
    # instead of baking them into the compiled program — configs that
    # differ only in these share one program (compile-aware HPO,
    # train/state.make_hparams)
    runtime_hparams: bool = False
    seed: int = 0
    log_freq: int = 20
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EncodingConfig:
    """One input encoding (hash grid by default, reference model.py:66-68)."""

    otype: str = "HashGrid"
    n_levels: int = 20
    n_features_per_level: int = 2
    log2_hashmap_size: int = 18
    base_resolution: int = 16
    per_level_scale: float = 2.0
    # "trilinear" (tcnn's "Linear", 8 corners/level), "simplex" (Kuhn
    # tetrahedral, 4 vertices/level — halves the gather/scatter row
    # stream on TPU; see avr_tpu/models/hashgrid.py), "hybrid[:N]"
    # (trilinear on the N finest levels, simplex below — N defaults to
    # half the levels), or "levels:<s|t per level, coarsest first>".
    # Unrecognized values (e.g. tcnn's "Smoothstep") fall back to
    # trilinear.
    interpolation: str = "trilinear"
    # Frequency-encoding fallback (otype == "Frequency").
    n_frequencies: int = 12
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_output_dims(self) -> int:
        if self.otype.lower() in ("hashgrid", "grid", "densegrid"):
            return self.n_levels * self.n_features_per_level
        if self.otype.lower() == "frequency":
            return 3 * 2 * self.n_frequencies
        if self.otype.lower() == "identity":
            return 3
        raise ValueError(f"unknown encoding otype {self.otype!r}")


@dataclass
class MLPConfig:
    """One MLP stack (reference model.py sigma/signal networks)."""

    n_neurons: int = 128
    n_hidden_layers: int = 3
    activation: str = "ReLU"
    output_activation: str = "None"
    otype: str = "FullyFusedMLP"  # accepted for YAML-compat, ignored
    use_bias: bool = True
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ChannelEmbedConfig:
    """Microphone-channel conditioning (fork addition, model.py:71-89)."""

    is_embed: bool = False
    connection_type: str = "add"  # "add" (per-layer bias) | "concat"
    ch_num: int = 8
    is_sigma_encoder: bool = False
    is_sigma_decoder: bool = False
    is_signal_network: bool = False
    emb_dim_sigma_encoder: int = 0
    emb_dim_sigma_decoder: int = 0
    emb_dim_signal_network: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelConfig:
    signal_output_dim: int = 2400
    leaky_relu: float = 0.01  # slope; only the complex variant reads the YAML
    # Standard model (MeshRIR / Simu / Real_env — model.py:63-235).
    pos_encoding_sigma: EncodingConfig = field(default_factory=EncodingConfig)
    dir_encoding_sig: EncodingConfig = field(default_factory=EncodingConfig)
    tx_encoding_sig: EncodingConfig = field(default_factory=EncodingConfig)
    # Complex model extras (RAF — model.py:238-331).
    tx_pos_encoding_sigma: Optional[EncodingConfig] = None
    pos_encoding_sig: Optional[EncodingConfig] = None
    tx_pos_encoding_sig: Optional[EncodingConfig] = None
    tx_dir_encoding_sig: Optional[EncodingConfig] = None
    sigma_encoder_network: MLPConfig = field(default_factory=MLPConfig)
    sigma_decoder_network: MLPConfig = field(default_factory=MLPConfig)
    signal_network: MLPConfig = field(
        default_factory=lambda: MLPConfig(n_neurons=512, otype="CutlassMLP")
    )
    channel_embed: ChannelEmbedConfig = field(default_factory=ChannelEmbedConfig)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class AVRConfig:
    path: PathConfig = field(default_factory=PathConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "AVRConfig":
        return cls(
            path=_build(PathConfig, raw.get("path", {})),
            render=_build_render(raw.get("render", {})),
            train=_build(TrainConfig, raw.get("train", {})),
            model=_build_model(raw.get("model", {})),
        )

    @classmethod
    def from_yaml(cls, path: str) -> "AVRConfig":
        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw or {})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


# ----------------------------------------------------------------------
def _coerce(klass, known: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce scalar fields to their declared type.

    YAML 1.1 parses exponent literals without a dot ('2e-4', '1e-3' —
    the style every reference config uses, e.g.
    reference/config_files/avr_raf_furnished.yml:25) as STRINGS; coerce
    them (and int-typed fields given floats/strings) to the dataclass
    field types instead of crashing downstream.
    """
    types = {f.name: f.type for f in dataclasses.fields(klass)}
    out = {}
    for k, v in known.items():
        t = str(types.get(k, ""))
        if t == "float" and not isinstance(v, float):
            v = float(v)
        elif t == "int" and not isinstance(v, int):
            v = int(float(v))
        elif t == "bool" and isinstance(v, str):
            v = v.strip().lower() in ("1", "true", "yes", "on")
        out[k] = v
    return out


def _extra(raw: Dict[str, Any], names) -> Dict[str, Any]:
    """Unknown keys, with those of a nested ``extra`` dict (as ``to_yaml``
    writes them) merged back in, so that a YAML backup loads as the config
    it was written from."""
    extra = dict(raw.get("extra") or {})
    extra.update({k: v for k, v in raw.items() if k not in names and k != "extra"})
    return extra


def _build(klass, raw: Dict[str, Any]):
    """Construct a dataclass from a dict, routing unknown keys into .extra."""
    names = {f.name for f in dataclasses.fields(klass)} - {"extra"}
    known = _coerce(klass, {k: v for k, v in raw.items() if k in names})
    return klass(**known, extra=_extra(raw, names))


def _build_render(raw: Dict[str, Any]) -> RenderConfig:
    raw = dict(raw)
    if "xyz_min" in raw:
        raw["xyz_min"] = _as_xyz(raw["xyz_min"])
    if "xyz_max" in raw:
        raw["xyz_max"] = _as_xyz(raw["xyz_max"])
    return _build(RenderConfig, raw)


_ENCODING_KEYS = (
    "pos_encoding_sigma",
    "dir_encoding_sig",
    "tx_encoding_sig",
    "tx_pos_encoding_sigma",
    "pos_encoding_sig",
    "tx_pos_encoding_sig",
    "tx_dir_encoding_sig",
)
_NETWORK_KEYS = (
    "sigma_encoder_network",
    "sigma_decoder_network",
    "signal_network",
)


def _build_model(raw: Dict[str, Any]) -> ModelConfig:
    raw = dict(raw)
    kwargs: Dict[str, Any] = {}
    for key in _ENCODING_KEYS:
        if key in raw:
            kwargs[key] = _build(EncodingConfig, raw.pop(key) or {})
    for key in _NETWORK_KEYS:
        if key in raw:
            kwargs[key] = _build(MLPConfig, raw.pop(key) or {})
    if "channel_embed" in raw:
        ch = raw.pop("channel_embed") or {}
        kwargs["channel_embed"] = _build(ChannelEmbedConfig, ch)
    names = {f.name for f in dataclasses.fields(ModelConfig)} - {"extra"}
    scalars = {}
    for k in list(raw):
        if k in names:
            scalars[k] = raw.pop(k)
    kwargs.update(_coerce(ModelConfig, scalars))
    return ModelConfig(**kwargs, extra=_extra(raw, names))
