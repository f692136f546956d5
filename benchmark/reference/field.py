"""The acoustic field: hash encodings and MLPs, queried point by point.

Parameters are a flat dict of named tensors (``shapes`` lists them):

* ``enc.<name>`` [rows, F]: the table of each hash encoding;
* ``<net>.w<i>`` [d_in, d_out] and ``<net>.b<i>`` [d_out] for the linear
  layers of ``sigma_encoder``, ``sigma_decoder`` and ``signal``;
* ``<net>.emb<i>`` [channels, width]: the microphone-channel rows that an
  "add" connection puts into hidden layer i before its activation;
* ``<net>.cat`` [channels, dim]: the rows a "concat" connection appends to
  the network's input.

Two variants, chosen by the data set. The standard one (every set but
RAF) encodes the point ``pos``, the view direction ``dir`` and the
transmitter ``tx``; its sigma encoder gives 128 features, the decoder the
attenuation, and the signal network reads (features, dir, tx). The
complex one (RAF) encodes the point twice (``pos`` for sigma, ``pos_sig``
for the signal), the transmitter position twice (``tx_pos``,
``tx_pos_sig``) and its heading (``tx_dir``); its sigma encoder gives 256
features and the signal network reads (relu(features), dir, tx_dir,
pos_sig, tx_pos_sig). Attenuation is |leaky_relu(decoder output)|, with
slope 0.01 in the standard variant and the configured one in the complex.
Every input is a [−1, 1] box coordinate, mapped to [0, 1] for the encoding.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn

from benchmark.reference import hashgrid
from benchmark.reference.precision import matmul

STANDARD_ENCODINGS = (("pos", "pos_encoding_sigma"), ("dir", "dir_encoding_sig"), ("tx", "tx_encoding_sig"))
COMPLEX_ENCODINGS = (
    ("pos", "pos_encoding_sigma"), ("tx_pos", "tx_pos_encoding_sigma"),
    ("pos_sig", "pos_encoding_sig"), ("tx_pos_sig", "tx_pos_encoding_sig"),
    ("dir", "dir_encoding_sig"), ("tx_dir", "tx_dir_encoding_sig"),
)
_DEFAULT_ENCODING = {
    "n_levels": 20, "n_features_per_level": 2, "log2_hashmap_size": 18,
    "base_resolution": 16, "per_level_scale": 2.0, "interpolation": "trilinear",
}


class Field:
    """The static shape of a field, from a configuration dict."""

    def __init__(self, cfg: dict):
        model = cfg["model"]
        self.complex = cfg["path"]["dataset_type"] == "RAF"
        self.T = int(model["signal_output_dim"])
        names = COMPLEX_ENCODINGS if self.complex else STANDARD_ENCODINGS
        self.grids = {n: hashgrid.grid(model.get(key) or _DEFAULT_ENCODING) for n, key in names}
        for n, key in names:
            otype = (model.get(key) or _DEFAULT_ENCODING).get("otype", "HashGrid").lower()
            if otype not in ("hashgrid", "grid", "densegrid"):
                raise ValueError(f"reference: encoding {key} is {otype}, not a hash grid")
        self.slope = float(model["leaky_relu"]) if self.complex else 0.01
        ch = model.get("channel_embed") or {}
        on = (not self.complex) and bool(ch.get("is_embed"))
        kind = ch.get("connection_type", "add")
        self.ch_num = int(ch.get("ch_num", 0))
        self.conn = {
            net: (kind if on and ch.get(flag) else "none")
            for net, flag in (("sigma_encoder", "is_sigma_encoder"), ("sigma_decoder", "is_sigma_decoder"),
                              ("signal", "is_signal_network"))
        }
        self.cat_dim = {
            net: int(ch.get(key, 0)) if self.conn[net] == "concat" else 0
            for net, key in (("sigma_encoder", "emb_dim_sigma_encoder"), ("sigma_decoder", "emb_dim_sigma_decoder"),
                             ("signal", "emb_dim_signal_network"))
        }
        feat = 256 if self.complex else 128
        out = {n: len(g.levels) * g.n_features for n, g in self.grids.items()}
        if self.complex:
            enc_in = out["pos"] + out["tx_pos"]
            sig_in = feat + out["dir"] + out["tx_dir"] + out["pos_sig"] + out["tx_pos_sig"]
        else:
            enc_in = out["pos"]
            sig_in = feat + out["dir"] + out["tx"]
        self.nets = {}
        for net, key, d_in, d_out in (
            ("sigma_encoder", "sigma_encoder_network", enc_in, feat),
            ("sigma_decoder", "sigma_decoder_network", feat, 1),
            ("signal", "signal_network", sig_in, self.T),
        ):
            mc = model[key]
            if str(mc.get("activation", "ReLU")).lower() != "relu" or \
                    str(mc.get("output_activation", "None")).lower() not in ("none", "linear", "identity"):
                raise ValueError(f"reference: {key} needs ReLU hidden layers and a linear output")
            width, hidden = int(mc["n_neurons"]), int(mc["n_hidden_layers"])
            dims = [d_in + self.cat_dim[net]] + [width] * hidden + [d_out]
            self.nets[net] = {"dims": dims, "bias": bool(mc.get("use_bias", True)), "width": width,
                              "hidden": hidden}

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Name → shape of every parameter."""
        out = {f"enc.{n}": (g.rows, g.n_features) for n, g in self.grids.items()}
        for net, spec in self.nets.items():
            dims = spec["dims"]
            for i in range(len(dims) - 1):
                out[f"{net}.w{i}"] = (dims[i], dims[i + 1])
                if spec["bias"]:
                    out[f"{net}.b{i}"] = (dims[i + 1],)
            if self.conn[net] == "add":
                for i in range(spec["hidden"]):
                    out[f"{net}.emb{i}"] = (self.ch_num, spec["width"])
            if self.conn[net] == "concat" and self.cat_dim[net]:
                out[f"{net}.cat"] = (self.ch_num, self.cat_dim[net])
        return out

    def mlp_macs_per_point(self) -> int:
        """Multiply-adds of the three networks for one query point."""
        return sum(a * b for spec in self.nets.values() for a, b in zip(spec["dims"][:-1], spec["dims"][1:]))


def mlp(p: Dict[str, torch.Tensor], fld: Field, net: str, x: torch.Tensor,
        ch: Optional[torch.Tensor], precision: str) -> torch.Tensor:
    spec = fld.nets[net]
    if fld.conn[net] == "concat" and fld.cat_dim[net]:
        x = torch.cat([x, p[f"{net}.cat"][ch].expand(*x.shape[:-1], -1)], dim=-1)
    n_layers = len(spec["dims"]) - 1
    h = x
    for i in range(n_layers):
        h = matmul(h, p[f"{net}.w{i}"], precision)
        if spec["bias"]:
            h = h + p[f"{net}.b{i}"]
        if i < n_layers - 1:
            if fld.conn[net] == "add":
                h = h + p[f"{net}.emb{i}"][ch]
            h = torch.relu(h)
    return h


def _enc(p, fld: Field, name: str, x: torch.Tensor, precision: str, lead) -> torch.Tensor:
    """Encode box coordinates x [..., 3] and broadcast to ``lead`` + [L·F]."""
    x01 = (x + 1.0) / 2.0
    out = hashgrid.encode(p[f"enc.{name}"], fld.grids[name], x01.reshape(-1, 3), precision)
    return out.reshape(*x.shape[:-1], out.shape[-1]).expand(*lead, -1)


def query(p: Dict[str, torch.Tensor], fld: Field, pts: torch.Tensor, view: torch.Tensor,
          tx: torch.Tensor, tx_view: Optional[torch.Tensor], ch: Optional[torch.Tensor],
          precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(attenuation [...], signal [..., T]) at points pts [..., 3] seen along
    view [..., 3] from a transmitter at tx [..., 3] (heading tx_view), for
    microphone channels ch [...] (standard variant). The other inputs
    broadcast against pts' leading dims and are encoded at their own size."""
    lead = pts.shape[:-1]

    def enc(name, x):
        return _enc(p, fld, name, x, precision, lead)

    if fld.complex:
        feat = mlp(p, fld, "sigma_encoder", torch.cat([enc("pos", pts), enc("tx_pos", tx)], -1), None, precision)
        raw = mlp(p, fld, "sigma_decoder", torch.relu(feat), None, precision)
        sig_in = torch.cat([
            torch.relu(feat), enc("dir", view), enc("tx_dir", tx_view), enc("pos_sig", pts), enc("tx_pos_sig", tx),
        ], dim=-1)
        signal = mlp(p, fld, "signal", sig_in, None, precision)
    else:
        feat = mlp(p, fld, "sigma_encoder", enc("pos", pts), ch, precision)
        raw = mlp(p, fld, "sigma_decoder", torch.relu(feat), ch, precision)
        sig_in = torch.cat([feat, enc("dir", view), enc("tx", tx)], -1)
        signal = mlp(p, fld, "signal", sig_in, ch, precision)
    return torch.abs(Fn.leaky_relu(raw[..., 0], fld.slope)), signal

