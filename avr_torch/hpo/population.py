"""Population HPO: K trials advanced in lockstep by one batched step (port of
``avr_tpu/hpo/population.py``).

The reference's Optuna loop trains one trial at a time
(reference/optuna_avr_runner.py:141-164). Here K runtime-variant trials —
configs that differ only in the runtime hyper-parameter bundle
(``TrainConfig.runtime_hparams``) — share one data stream and one
ray-direction sequence, and their params and optimizer state are stacked
on a leading [K] axis (``train/state.make_train_step(population=K)``):

  * the hash encodes of all K tables run in one launch each way, their
    corners computed once for the shared points (``ops/hashgrid_encode``);
  * the MLP products run as batched matmuls over the trials;
  * each trial keeps its own loss, clip, non-finite skip, rate and decay;
  * validation renders all K at once and writes each trial's
    ``val_iter*.npz`` into its own logdir, so the standard DoA objective
    (``hpo/runner.doa_objective_from_logdir``) applies to each unchanged.

``run_population_study`` drives a study through its ask/tell surface: ask K
trials, train them as one population, tell K results.
"""

from __future__ import annotations

import copy
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from avr_torch.config import AVRConfig
from avr_torch.data.loaders import Dataset, load_dataset
from avr_torch.data.sampler import BatchSampler
from avr_torch.device import resolve_device
from avr_torch.hpo.runner import doa_objective_from_logdir, update_config
from avr_torch.losses import CriterionConfig
from avr_torch.models import field as field_lib
from avr_torch.render.common import make_consts
from avr_torch.train.runner import device_batch, eval_directions, iteration_generator
from avr_torch.train.state import (
    init_state, make_hparams, make_train_step, stack_hparams, stack_states,
)

# Config fields allowed to differ between population members: exactly the
# runtime-hparam bundle (everything else changes the model or the program).
_RUNTIME_FIELDS = (
    "lr", "eta_min", "weight_decay", "spec_loss_weight",
    "amplitude_loss_weight", "angle_loss_weight", "time_loss_weight",
    "energy_loss_weight", "multistft_loss_weight", "das_reg_loss_weight",
    "das_ce_loss_weight",
)


def _structural_key(cfg: AVRConfig) -> str:
    """Serialized config with the runtime fields and expname masked out."""
    c = copy.deepcopy(cfg)
    for f in _RUNTIME_FIELDS:
        if f.startswith("das_"):
            # DAS weights: the value is runtime but zero against nonzero is
            # structural — the beamforming branch exists only when the static
            # weight is > 0
            setattr(c.train, f, 1.0 if getattr(c.train, f) > 0 else 0.0)
        else:
            setattr(c.train, f, 1.0)
    c.path.expname = "_"
    return json.dumps(c.to_dict(), sort_keys=True, default=str)


class PopulationRunner:
    """Train K structurally identical trial configs as one population.

    The loop counts iterations on the host (a trial whose update was
    skipped for a non-finite energy keeps its own, lower step count).
    """

    def __init__(
        self,
        cfgs: List[AVRConfig],
        dataset_dir: Optional[str],
        train_data: Optional[Dataset] = None,
        test_data: Optional[Dataset] = None,
        device="cuda",
    ):
        if not cfgs:
            raise ValueError("a population needs at least one trial config")
        self.device = resolve_device(device)
        base = cfgs[0]
        tc = base.train
        if not tc.runtime_hparams:
            raise ValueError(
                "population trials must use runtime_hparams (the 'runtime' HPO "
                "variant): trial identity must be a runtime hyper-parameter bundle"
            )
        key0 = _structural_key(base)
        for i, c in enumerate(cfgs[1:], 1):
            if _structural_key(c) != key0:
                raise ValueError(
                    f"population member {i} differs structurally from member 0 — "
                    "only runtime hparams may vary"
                )
        self.cfgs = cfgs
        self.K = len(cfgs)
        self.logdirs = [os.path.join(c.path.logdir, c.path.expname) for c in cfgs]
        for d, c in zip(self.logdirs, cfgs):
            os.makedirs(d, exist_ok=True)
            c.to_yaml(os.path.join(d, "avr_conf.yml"))

        seq_len = base.model.signal_output_dim
        dt = base.path.dataset_type
        self.train_data = train_data if train_data is not None else load_dataset(
            dataset_dir, dt, eval=False, seq_len=seq_len, fs=base.render.fs
        )
        self.test_data = test_data if test_data is not None else load_dataset(
            dataset_dir, dt, eval=True, seq_len=seq_len, fs=base.render.fs
        )
        group8 = bool(tc.das_reg_loss_weight > 0 or tc.das_ce_loss_weight > 0) and bool(
            tc.extra.get("group_sampling", False)
        )
        self.batch_size = tc.batch_size
        self.train_sampler = BatchSampler(
            self.train_data, self.batch_size, shuffle=True, seed=tc.seed, jitter=True, group8=group8,
        )

        self.fstatic = field_lib.build_field(base.model, dt)
        self.consts = make_consts(base.render, seq_len, device=self.device)
        self.crit = CriterionConfig.from_configs(tc, base.render)
        # one init, stacked K times: serial runtime-variant trials share
        # train.seed, so their inits are this one and the trials diverge
        # through their hyper-parameter bundles alone
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.state = stack_states([init_state(gen, self.fstatic, tc, device=self.device)] * self.K)
        self._step_fn, self._render_fn = make_train_step(
            self.fstatic, self.consts, base.render, tc, self.crit, population=self.K,
        )
        # the [K]-stacked hyper-parameter bundle: each trial's identity
        self.hp = stack_hparams([make_hparams(c.train, self.device) for c in cfgs])

    # ------------------------------------------------------------------
    def train(self, log=print) -> None:
        tc = self.cfgs[0].train
        if len(self.train_sampler) == 0:
            raise ValueError(
                f"train: {len(self.train_data)} training rows make no batch of {self.batch_size}"
            )
        it = int(self.state.step.max())
        steps_per_call = max(1, tc.steps_per_call)
        pending: list = []
        t_log, n_since_log = time.time(), 0
        while it < tc.total_iterations:
            for batch in self.train_sampler.epoch():
                pending.append(batch)
                if len(pending) < steps_per_call:
                    continue
                # steps_per_call population steps per host iteration, inner
                # step keyed it0 + k, as AVRRunner does
                for b in pending:
                    it += 1
                    self.state, bundle = self._step_fn(
                        self.state, device_batch(b, self.device),
                        iteration_generator(tc.seed, it, self.device), self.hp,
                    )
                it_prev = it - len(pending)
                n_since_log += len(pending)
                pending = []

                def crossed(freq: int) -> bool:
                    return it // freq > it_prev // freq

                if crossed(tc.log_freq):
                    tot = bundle.total.cpu().numpy()  # [K], the last inner step's
                    # every step since the last log, over the time since then
                    rate = n_since_log * self.K * self.batch_size / max(time.time() - t_log, 1e-9)
                    log(
                        f"pop@{it} loss[{self.K} trials] min={tot.min():.3f} "
                        f"med={np.median(tot):.3f} max={tot.max():.3f} ({rate:.0f} samp/s)"
                    )
                    t_log, n_since_log = time.time(), 0
                if crossed(tc.val_freq) and it > 0:
                    self.dump_val_npz(it)
                if it >= tc.total_iterations:
                    break

    # ------------------------------------------------------------------
    def dump_val_npz(self, iteration: int) -> None:
        """Render the test split for all trials at once, with the fixed eval
        directions of AVRRunner (``EVAL_SEED``), and write each trial's
        ``val_result/val_iter{it:06d}.npz`` in AVRRunner.validate's layout."""
        base = self.cfgs[0]
        dirs = eval_directions(base.render, self.device)
        bs = self.batch_size
        data = self.test_data
        sampler = BatchSampler(data, bs, shuffle=False, jitter=False, drop_last=False)
        preds: list = []  # per batch: [K, n, F]
        oris: list = []
        for batch in sampler.epoch():
            n_real = batch["pos_rx"].shape[0]
            if n_real < bs:  # one render shape: pad by repeating the last row
                batch = {
                    k: np.concatenate([v, np.repeat(v[-1:], bs - n_real, axis=0)])
                    for k, v in batch.items()
                }
            with torch.no_grad():
                out = self._render_fn(self.state.params, device_batch(batch, self.device), dirs)
            out = out.cpu().numpy()
            preds.append((out[..., 0] + 1j * out[..., 1]).astype(np.complex64)[:, :n_real])
            wave = batch["wave"][:n_real]
            oris.append((wave[..., 0] + 1j * wave[..., 1]).astype(np.complex64))
        pred_all = np.concatenate(preds, axis=1)  # [K, N, F]
        ori = np.concatenate(oris)  # [N, F]
        for k, logdir in enumerate(self.logdirs):
            npz_dir = os.path.join(logdir, "val_result")
            os.makedirs(npz_dir, exist_ok=True)
            payload = dict(
                ori_sig=ori, pred_sig=pred_all[k],
                position_rx=data.pos_rx, position_tx=data.pos_tx, fs=base.render.fs,
            )
            if data.ch_idx is not None:
                payload["ch_idx"] = data.ch_idx
            np.savez_compressed(os.path.join(npz_dir, f"val_iter{iteration:06d}.npz"), **payload)


def run_population_study(
    study, base_cfg: AVRConfig, dataset_dir: str, n_trials: int, K: int,
    start_index: int = 0, device="cuda", log=print, workers: int = 2,
) -> list:
    """Ask K trials, train them as one population, tell K results; until
    ``n_trials`` trials have been asked. Returns [(trial number, value or
    None)] of the trials told in this call.

    Every population is full width (K trials), so the last one may take the
    study past ``n_trials``. A population that fails to train, and a trial
    whose objective fails, are told as FAIL and count toward ``n_trials``.
    The DoA objectives are numpy and run in ``workers`` processes, started
    with ``spawn``: a forked child would inherit the parent's CUDA context.
    """
    told: list = []
    asked = 0
    spawn = multiprocessing.get_context("spawn")
    while asked < n_trials:
        trials = [study.ask() for _ in range(K)]
        asked += K
        cfgs = [update_config(base_cfg, start_index, t.number, t, "runtime") for t in trials]
        try:
            pop = PopulationRunner(cfgs, dataset_dir, device=device)
            pop.train(log=log)
            logdirs = pop.logdirs
            del pop
        except Exception as e:  # one bad population must not end the study
            log(f"trials {[t.number for t in trials]} failed to train: {type(e).__name__}: {e}")
            for t in trials:
                study.tell(t, None, state="FAIL")
                told.append((t.number, None))
            continue
        with ProcessPoolExecutor(max_workers=max(1, min(workers, K)), mp_context=spawn) as ex:
            futs = [ex.submit(doa_objective_from_logdir, d, base_cfg.render.fs) for d in logdirs]
            for t, fut in zip(trials, futs):
                try:
                    value = float(fut.result())
                except Exception as e:  # one bad trial must not kill the batch
                    log(f"trial {t.number} objective failed: {type(e).__name__}: {e}")
                    study.tell(t, None, state="FAIL")
                    told.append((t.number, None))
                    continue
                study.tell(t, value)
                told.append((t.number, value))
    return told
