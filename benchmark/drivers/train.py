"""Training cells: the program's train step, one trial or K in lockstep.

Set-up draws the weights, builds the step (``make_train_step``), and
drives it through its first three steps by the window's own feed: each
step takes the next batch of the pool (no two of the three alike) and
ray directions freshly drawn from the seed, handed over as ``dirs``. The
window goes on with the same state object and feed. The reference follows
the first three steps from the same weights, batches and directions.

Numbers (``NUMBERS``), each the worst over the trials; a run computes
those its ``workloads/<cell>.json`` limits name, ``readings.py`` all of
them (PERF.md §6 says which a cell compares and why):
* ``first_pred_gap``: ‖program − reference‖ / ‖reference‖ of the first
  step's rendered spectra, read where the step hands them to its
  criterion;
* ``first_loss_gap``, ``loss_gap``: |program − reference| / |reference| of
  the first step's total loss, and the largest over the three steps;
  ``first_core_gap`` the same without the direction (DAS) terms;
  ``first_terms_gap`` the largest over the first step's terms, each over
  the larger of its reference value and a thousandth of the total;
* ``grad_gap``, ``grad_gap_median``: over the leaves, the largest and the
  median gap between the norms of the first step's clipped gradient as
  Adam receives it (the program's read from its first moment after one
  step, m/(1 − β1)), over the larger of that leaf's reference norm and the
  median leaf's;
* ``change_gap``, ``change_gap_median``: the same for the norm of each
  leaf's change over the three steps, leaving out leaves whose reference
  gradient norm is under a thousandth of the median leaf's (Adam moves
  those by round-off alone);
* ``table_change_gap``: the gap of the norm of all hash tables' change
  over the three steps taken together (the tables are what the encode
  backward kernel's gradient moves), over the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import statistics
from typing import Dict, Iterable, List

import torch

from benchmark import counts, inputs, weights
from benchmark.reference import Reference, hparams
from benchmark.reference.field import Field
from benchmark.reference.precision import FP32
from benchmark.reference.render import Geometry

FIRST_STEPS = 3
BETA1 = 0.9
DIRECTION_TERMS = ("das_reg", "das_ce")


def leaf_norms(leaves: Dict[str, torch.Tensor], trials: int) -> List[Dict[str, float]]:
    """Per trial, name → L2 norm (a leading K axis when ``trials``)."""
    if not trials:
        return [{n: float(torch.linalg.vector_norm(t.float())) for n, t in leaves.items()}]
    return [{n: float(torch.linalg.vector_norm(t[k].float())) for n, t in leaves.items()} for k in range(trials)]


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], skip=()) -> List[float]:
    """Per leaf, |got − ref| / max(ref, the median leaf's ref)."""
    names = [n for n in ref if n not in skip]
    med = statistics.median(ref[n] for n in names)
    return [abs(got[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]


class Session:
    kind = "train"

    def __init__(self, cfg_dict: dict, traffic: dict, seed: int, device):
        from avr_torch.config import AVRConfig
        from avr_torch.losses import CriterionConfig
        from avr_torch.models import field
        from avr_torch.render.common import make_consts
        from avr_torch.train import state as st

        self.device, self.seed, self.cfg_dict = device, seed, cfg_dict
        cfg = AVRConfig.from_dict(cfg_dict)
        self.rc, tc = cfg.render, cfg.train
        self.fld = Field(cfg_dict)
        self.K = int(traffic.get("population", 0))
        if self.K:
            self.trials = inputs.population_trials({**traffic["trials"], "count": self.K}, seed)
            tcs = [dataclasses.replace(tc, runtime_hparams=True, **t) for t in self.trials]
            self.hp = st.stack_hparams([st.make_hparams(t, device) for t in tcs])
            tc = tcs[0]
        fst = field.build_field(cfg.model, cfg.path.dataset_type)
        consts = make_consts(self.rc, cfg.model.signal_output_dim, device=device)
        crit = CriterionConfig.from_configs(tc, self.rc)
        self.step, _ = st.make_train_step(fst, consts, self.rc, tc, crit, population=self.K)
        drawn = weights.draw(self.fld, inputs.torch_generator(seed, 0, device), device)
        self.w0 = {n: t.to("cpu") for n, t in drawn.items()}
        state = st.init_state(None, fst, tc, device=device, params=weights.program_tree(drawn, self.fld))
        del drawn
        self.state = st.stack_states([state] * self.K) if self.K else state
        self.named_leaves = st.named_leaves
        self.batches = inputs.Batches(cfg_dict, traffic["batches"], seed, device)
        self.dir_gen = inputs.torch_generator(seed, 5, device)
        self.points = tc.batch_size * self.rc.n_rays * self.rc.n_samples
        self.energies: List[torch.Tensor] = []  # each step's energy term, counted after the window

    # -- the feed and the call the window times ------------------------
    def feed(self):
        i = self.batches.index()
        d = inputs.ray_directions(self.rc.n_azi, self.rc.n_ele, self.dir_gen, self.device)
        return i, self.batches.get(i), d

    def call(self, batch, dirs):
        if self.K:
            self.state, bundle = self.step(self.state, batch, dirs, self.hp)
        else:
            self.state, bundle = self.step(self.state, batch, dirs)
        self.energies.append(bundle.energy)
        return bundle

    # -- set-up ------------------------------------------------------------
    def warm_up(self) -> None:
        """The first steps, through the window's own feed and call. The
        first step's spectra are read where the step hands them to its
        criterion (``first_spectra``); no other forward pass runs."""
        self.first: List[tuple] = []
        loss, terms = [], []
        for n in range(FIRST_STEPS):
            i, batch, d = self.feed()
            self.first.append((i, d.clone()))
            if n == 0:
                with first_spectra() as seen:
                    bundle = self.call(batch, d)
                pred = torch.stack(seen) if self.K else seen[0]
            else:
                bundle = self.call(batch, d)
            loss.append(bundle.total.detach().reshape(-1).tolist())
            terms.append({k: v.detach().reshape(-1).tolist() for k, v in bundle.as_dict().items()})
            if n == 0:
                mu = dict(self.named_leaves(self.state.opt_state.mu))
                first = leaf_norms({k: v / (1 - BETA1) for k, v in mu.items()}, self.K)
        p3 = dict(self.named_leaves(self.state.params))
        p0 = weights.program_leaves(self.w0, self.fld)
        change = leaf_norms({n: p3[n] - p0[n].to(self.device) for n in p3}, self.K)
        self.readings = [{"loss": [step[k] for step in loss], "first": first[k], "change": change[k],
                          "terms": [{n: v[k] for n, v in step.items()} for step in terms],
                          "pred": pred[k] if self.K else pred}
                         for k in range(max(1, self.K))]

    # -- the window --------------------------------------------------------
    def window(self, seconds: float, clock) -> dict:
        t0 = clock()
        calls, first = 0, len(self.energies)
        while True:
            _, batch, d = self.feed()
            self.call(batch, d)
            calls += 1
            if clock() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = clock() - t0
        trials = max(1, self.K)
        failed = int((~torch.isfinite(torch.stack(self.energies[first:]))).sum())
        return {"seconds": elapsed, "calls": calls, "attempted": calls * trials,
                "failed": failed, "trials_per_call": trials}

    def traced_call(self, i: int) -> None:
        idx, batch, d = self.feed()
        self.traced.append((idx, d))
        self.call(batch, d)

    def work(self) -> dict:
        """Per call: MLP FLOPs and the encodes' least time, over the traced calls."""
        geo = Geometry(self.cfg_dict, self.fld.T, self.device)
        least = []
        for idx, d in self.traced:
            ins = counts.encode_inputs(geo.box, self.batches.get(idx), d, geo.d)
            least.append(counts.least_seconds(counts.encode_work(self.fld, ins, self.K)))
        return {"model_flops_per_call": counts.model_flops(self.fld, self.points, self.K, backward=True),
                "encode_least_s_per_call": sum(least) / len(least)}

    # -- correctness ---------------------------------------------------------
    def release(self) -> None:
        del self.state, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, precision: str = FP32, batch_fault=None, grad_fault=None) -> List[dict]:
        """Per trial: the reference's losses, first clipped gradient norms,
        change norms, from the first steps' weights, batches and dirs.
        ``batch_fault`` rewrites the batches the reference sees,
        ``grad_fault`` each step's gradient."""
        ref = Reference(self.cfg_dict, self.device, precision, ray_block=self._ray_block())
        batches = [self.batches.get(i) for i, _ in self.first]
        if batch_fault is not None:
            batches = [batch_fault(b) for b in batches]
        dirs = [d for _, d in self.first]
        out = []
        for t in (self.trials if self.K else [None]):
            w = {n: v.to(self.device) for n, v in self.w0.items()}
            r = ref.train(w, batches, dirs, hparams(self.cfg_dict, t), grad_fault)
            first = weights.program_leaves(r["first_update"], self.fld)
            p0 = weights.program_leaves(w, self.fld)
            p3 = weights.program_leaves(r["params"], self.fld)
            out.append({
                "loss": r["loss"], "terms": r["terms"], "pred": r["first_pred"],
                "first": leaf_norms(first, 0)[0],
                "change": leaf_norms({n: p3[n] - p0[n] for n in p3}, 0)[0],
            })
            del r, w, first, p0, p3
        return out

    def _ray_block(self) -> int:
        per_ray = self.points // self.rc.n_rays
        return max(1, min(self.rc.n_rays, 2 ** 17 // per_ray))

    def check(self, names: Iterable[str]) -> Dict[str, float]:
        return numbers(self.readings, self.reference_readings(), names)


@contextlib.contextmanager
def first_spectra():
    """While open, the spectra each criterion call of the program's step
    receives are kept (one per trial); the program's criterion is put back
    on closing, so the window runs the step unobserved."""
    from avr_torch.train import state as st

    seen, criterion = [], st.criterion

    def observed(pred, *args, **kwargs):
        seen.append(pred.detach().clone())
        return criterion(pred, *args, **kwargs)

    st.criterion = observed
    try:
        yield seen
    finally:
        st.criterion = criterion


def _rel(got: float, ref: float) -> float:
    return abs(got - ref) / max(abs(ref), 1e-30)


def _still(r: dict) -> set:
    """Leaves whose reference gradient is nought to rounding."""
    med = statistics.median(r["first"].values())
    return {n for n, v in r["first"].items() if v < 1e-3 * med}


def _core(terms: dict) -> float:
    return sum(v for t, v in terms.items() if t not in DIRECTION_TERMS)


def _terms_gap(g: dict, r: dict) -> float:
    scale = 1e-3 * abs(r["loss"][0])
    return max(abs(g["terms"][0][t] - v) / max(abs(v), scale, 1e-30) for t, v in r["terms"][0].items())


def _tables(norms: Dict[str, float]) -> float:
    return math.sqrt(sum(v * v for n, v in norms.items() if n.startswith("enc.")))


def _pred_gap(g: dict, r: dict) -> float:
    return float(torch.linalg.vector_norm(g["pred"].float() - r["pred"]) / torch.linalg.vector_norm(r["pred"]))


# name → number of one trial's readings ``g`` against the reference's ``r``
NUMBERS = {
    "first_pred_gap": _pred_gap,
    "first_loss_gap": lambda g, r: _rel(g["loss"][0], r["loss"][0]),
    "loss_gap": lambda g, r: max(_rel(a, b) for a, b in zip(g["loss"], r["loss"])),
    "first_core_gap": lambda g, r: _rel(_core(g["terms"][0]), _core(r["terms"][0])),
    "first_terms_gap": _terms_gap,
    "grad_gap": lambda g, r: max(leaf_gaps(g["first"], r["first"])),
    "grad_gap_median": lambda g, r: statistics.median(leaf_gaps(g["first"], r["first"])),
    "change_gap": lambda g, r: max(leaf_gaps(g["change"], r["change"], skip=_still(r))),
    "change_gap_median": lambda g, r: statistics.median(leaf_gaps(g["change"], r["change"], skip=_still(r))),
    "table_change_gap": lambda g, r: _rel(_tables(g["change"]), _tables(r["change"])),
}


def numbers(got: List[dict], refs: List[dict], names: Iterable[str] = NUMBERS) -> Dict[str, float]:
    """The named numbers of readings ``got`` against the reference's, each
    the worst over the trials (a NaN stays)."""
    out = {}
    for k in names:
        vals = [NUMBERS[k](g, r) for g, r in zip(got, refs)]
        out[k] = next((v for v in vals if v != v), max(vals))
    return out
