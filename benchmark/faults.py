"""Faults planted under the timed path, for the checks that ``correct``
catches them (``tests/test_bench_faults.py``) and for their readings at a
cell's own size (``readings.py``). The benchmark's runs never plant one.

Each fault wraps ``avr_torch.train.state.make_train_step``, which every
driver calls, so the step or the render it returns is the broken one:

* ``unchanged``: the step returns the state it was given;
* ``half_batch``: the step or render sees its batch's second half replaced
  by the first, so the loss is the mean over half the rows;
* ``tables_unchanged``: the step's new state keeps the hash tables and
  their moments of the state it was given, as a table gradient of zero
  leaves them from zero moments and without decay;
* ``altered``: the render's answer has two rows swapped where it is made;
* ``stale``: the render answers every request with its first answer.

``zero_tables`` plants the zero table gradient in the reference put in
the program's place instead (``readings.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


def half_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """t with the second half of its rows along ``dim`` replaced by the first."""
    h = t.shape[dim] // 2
    first = t.narrow(dim, 0, h)
    return torch.cat([first, first, t.narrow(dim, 2 * h, t.shape[dim] - 2 * h)], dim=dim)


def half_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch with its second half of rows replaced by its first."""
    return {k: half_rows(v) for k, v in batch.items()}


def zero_tables(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The gradient with every hash table's part set to zero."""
    return {k: torch.zeros_like(v) if k.startswith("enc.") else v for k, v in grads.items()}


def _keep_tables(new, old):
    """``new`` with the hash tables and their moments of ``old``."""
    def kept(tree, before):
        return {**tree, "enc": before["enc"]}

    opt = type(new.opt_state)(kept(new.opt_state.mu, old.opt_state.mu), kept(new.opt_state.nu, old.opt_state.nu))
    return new._replace(params=kept(new.params, old.params), opt_state=opt)


def swap_rows(out: torch.Tensor) -> torch.Tensor:
    return torch.cat([out[1:2], out[:1], out[2:]])


def _wrap(make, fault: str):
    def patched(*args, **kwargs):
        step, render = make(*args, **kwargs)

        def bad_step(state, batch, dirs, *rest):
            if fault == "half_batch":
                batch = half_batch(batch)
            new, bundle = step(state, batch, dirs, *rest)
            if fault == "tables_unchanged":
                new = _keep_tables(new, state)
            return (state if fault == "unchanged" else new), bundle

        first = []

        def bad_render(params, batch, dirs):
            if fault == "half_batch":
                batch = half_batch(batch)
            out = render(params, batch, dirs)
            if fault == "altered":
                out = swap_rows(out)
            if fault == "stale":
                if not first:
                    first.append(out)
                out = first[0]
            return out

        return bad_step, bad_render

    return patched


@contextlib.contextmanager
def planted(fault: str):
    """``make_train_step`` returns the broken step and render while open."""
    from avr_torch.train import state as st

    make = st.make_train_step
    st.make_train_step = _wrap(make, fault)
    try:
        yield
    finally:
        st.make_train_step = make
