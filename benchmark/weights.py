"""Weights drawn from the seed on the device, and the program's layout of them.

The benchmark draws every parameter of the reference's field
(``reference.field.Field.shapes``) in two calls on the device: one
uniform draw for all hash tables (U(±1e−4), instant-ngp's start) and one
normal draw for all weights and channel embeddings (He-normal weights,
embeddings N(0, 1/width)); biases start at 0. The reference takes them as
they are. ``program_tree`` lays the same values out as the program's
parameter tree: nested dicts and lists, and the point's two encodings
stored side by side in one table ``enc.pos_pair`` where they share a
geometry.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.field import Field

_CAT = {"sigma_encoder": "enc", "sigma_decoder": "dec", "signal": "sig"}


def draw(fld: Field, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    shapes = fld.shapes()
    tables = [n for n in shapes if n.startswith("enc.")]
    normals = [n for n in shapes if ".w" in n or ".emb" in n or n.endswith(".cat")]

    def numel(n):
        return int(torch.Size(shapes[n]).numel())

    out = {}
    flat = torch.rand(sum(numel(n) for n in tables), generator=generator, device=device)
    flat = flat * 2e-4 - 1e-4
    for n, part in zip(tables, torch.split(flat, [numel(n) for n in tables])):
        out[n] = part.view(shapes[n])
    flat = torch.randn(sum(numel(n) for n in normals), generator=generator, device=device)
    for n, part in zip(normals, torch.split(flat, [numel(n) for n in normals])):
        scale = (2.0 / shapes[n][0]) ** 0.5 if ".w" in n else shapes[n][1] ** -0.5
        out[n] = (part * scale).view(shapes[n])
    for n in shapes:
        if ".b" in n:
            out[n] = torch.zeros(shapes[n], device=device)
    return out


def paired(fld: Field) -> bool:
    """Whether the program stores pos and pos_sig as one table."""
    return fld.complex and fld.grids["pos"] == fld.grids["pos_sig"]


def program_leaves(p: Dict[str, torch.Tensor], fld: Field) -> Dict[str, torch.Tensor]:
    """The program's leaf name (``named_leaves``' dotted form) → tensor."""
    out = {}
    for n, t in p.items():
        net, _, part = n.partition(".")
        if net == "enc":
            if paired(fld) and part in ("pos", "pos_sig"):
                continue
            out[n] = t
        elif part == "cat":
            out[f"concat_emb.{_CAT[net]}"] = t
        else:
            kind = part.rstrip("0123456789")
            out[f"{net}.{kind}.{part[len(kind):]}"] = t
    if paired(fld):
        out["enc.pos_pair"] = torch.cat([p["enc.pos"], p["enc.pos_sig"]], dim=-1)
    return out


def program_tree(p: Dict[str, torch.Tensor], fld: Field) -> dict:
    """The program's parameter tree of the weights ``p``."""
    tree = {"enc": {}, "concat_emb": {}}
    for net in _CAT:
        tree[net] = {"w": [], "b": [], "emb": []}
    for name, t in sorted(program_leaves(p, fld).items(), key=lambda kv: _order(kv[0])):
        parts = name.split(".")
        if parts[0] in ("enc", "concat_emb"):
            tree[parts[0]][parts[1]] = t
        else:
            tree[parts[0]][parts[1]].append(t)
    return tree


def _order(name: str):
    parts = name.split(".")
    return (parts[0], parts[1], int(parts[2]) if len(parts) > 2 and parts[2].isdigit() else 0)
