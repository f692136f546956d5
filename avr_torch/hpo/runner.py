"""HPO driver: search spaces + train-and-DoA objective (port of
``avr_tpu/hpo/runner.py``; ``update_config`` and the objective are copies,
the trials train on the port's ``AVRRunner`` on the device the caller names).

Re-design of the five reference Optuna runners
(reference/optuna_avr_runner.py + _ch/_ch_without_das/_ch_only_das/_das
variants) as ONE parameterized driver:

  * ``update_config`` mutates a base AVRConfig per trial with the
    reference's search ranges (optuna_avr_runner.py:13-80) and scales
    every iteration budget inversely with batch size (:48-54);
  * variant="ch" adds the channel-embedding space (is_embed, add/concat,
    per-subnet flags/dims) and a DAS-regression weight with batch size
    forced to 8 while DAS is active (optuna_avr_runner_ch.py:18-95);
  * variant="ch_without_das" drops the DAS terms; "ch_only_das" fixes
    the channel config and searches only DAS; "das" searches DAS weights
    in [1,100] plus one shared embedding dim (optuna_avr_runner_das.py);
  * the objective trains the runner, runs NormMUSIC DoA on every
    val_iter*.npz (cached as pkl), and returns the min over checkpoints
    of the mean pred-vs-gt error (optuna_avr_runner.py:82-124) — 999
    when no checkpoint produced a usable estimate.
"""

from __future__ import annotations

import copy
import math
import os
import pickle
import re
from typing import Optional

import numpy as np

from avr_torch.config import AVRConfig
from avr_torch.eval.doa import run_doa_on_npz
from avr_torch.hpo.study import Trial, create_study


def update_config(
    cfg: AVRConfig, base_start_index: int, trial_index: Optional[int] = None,
    trial: Optional[Trial] = None, variant: str = "base",
) -> AVRConfig:
    cfg = copy.deepcopy(cfg)
    base_batch = cfg.train.batch_size
    if trial is not None and variant == "runtime":
        # Compile-aware space (VERDICT r3 item 7): sample ONLY
        # program-shape-invariant params — lr/eta_min/weight_decay and
        # the loss weights, all passed to the compiled step as runtime
        # scalars (TrainConfig.runtime_hparams) — so every trial reuses
        # one compiled program instead of paying a fresh remote compile.
        # Structure (batch size, ray/sample counts, widths, which DAS
        # terms exist) stays at the base config's values.
        t = cfg.train
        t.runtime_hparams = True
        # wider lr ceiling than the reference's base space (1e-4,
        # optuna_avr_runner.py:13-80, kept verbatim in the parity
        # variants below): the synthetic-array workload's known-good
        # optimum sits at 1e-3 (every full-budget gate run,
        # results/interp_fullbudget/) — a 1e-4 cap would exclude the
        # region a quality study must find. 'runtime' is this repo's
        # own compile-aware space, not a reference-parity one.
        t.lr = trial.suggest_float("lr", 1e-6, 2e-3, log=True)
        # eta_min as a FIXED-RANGE ratio of lr: per-trial-varying bounds
        # degrade TPE's per-parameter density models and make
        # cross-trial eta_min values scale-confounded (advisor r4).
        t.eta_min = t.lr * trial.suggest_float(
            "eta_min_ratio", 1e-2, 5e-1, log=True
        )
        t.weight_decay = trial.suggest_float("weight_decay", 0, 1e-3)
        t.spec_loss_weight = trial.suggest_float("spec_loss_weight", 0, 100)
        t.angle_loss_weight = trial.suggest_float("angle_loss_weight", 0, 100)
        t.time_loss_weight = trial.suggest_float("time_loss_weight", 0, 100)
        t.energy_loss_weight = trial.suggest_float("energy_loss_weight", 0, 100)
        t.multistft_loss_weight = trial.suggest_float("multistft_loss_weight", 0, 100)
        if t.das_reg_loss_weight > 0:  # value runtime, branch structural
            t.das_reg_loss_weight = trial.suggest_float(
                "das_reg_loss_weight", 1.0, 100.0, log=True
            )
        if t.das_ce_loss_weight > 0:
            t.das_ce_loss_weight = trial.suggest_float(
                "das_ce_loss_weight", 1.0, 100.0, log=True
            )
        batch_size = base_batch
    elif trial is not None:
        t = cfg.train
        batch_size = 2 ** trial.suggest_int("batch_size", 0, 3)
        t.lr = trial.suggest_float("lr", 1e-6, 1e-4, log=True)
        # eta_min as a FIXED-RANGE ratio of lr: per-trial-varying bounds
        # degrade TPE's per-parameter density models and make
        # cross-trial eta_min values scale-confounded (advisor r4).
        t.eta_min = t.lr * trial.suggest_float(
            "eta_min_ratio", 1e-2, 5e-1, log=True
        )
        cfg.render.n_samples = trial.suggest_int("n_samples", 40, 80)
        cfg.render.n_azi = trial.suggest_int("n_azi", 48, 80)
        t.weight_decay = trial.suggest_float("weight_decay", 0, 1e-3)
        t.spec_loss_weight = trial.suggest_float("spec_loss_weight", 0, 100)
        t.angle_loss_weight = trial.suggest_float("angle_loss_weight", 0, 100)
        t.time_loss_weight = trial.suggest_float("time_loss_weight", 0, 100)
        t.energy_loss_weight = trial.suggest_float("energy_loss_weight", 0, 100)
        t.multistft_loss_weight = trial.suggest_float("multistft_loss_weight", 0, 100)
        cfg.model.sigma_encoder_network.n_neurons = 2 ** trial.suggest_int(
            "sigma_encoder_network_n_neurons", 5, 9
        )
        cfg.model.sigma_decoder_network.n_neurons = 2 ** trial.suggest_int(
            "sigma_decoder_network_n_neurons", 5, 9
        )
        cfg.model.signal_network.n_neurons = 2 ** trial.suggest_int(
            "signal_network_n_neurons", 7, 10
        )
        _variant_space(cfg, trial, variant)
        batch_size = 8 if (
            cfg.train.das_reg_loss_weight > 0 or cfg.train.das_ce_loss_weight > 0
        ) else batch_size
    else:
        batch_size = base_batch

    # iteration budgets scale inversely with batch size (ceil)
    scale = batch_size / base_batch
    t = cfg.train
    t.batch_size = batch_size
    t.T_max = math.ceil(t.T_max / scale)
    t.total_iterations = math.ceil(t.total_iterations / scale)
    t.save_freq = math.ceil(t.save_freq / scale)
    t.val_freq = math.ceil(t.val_freq / scale)

    trial_num = base_start_index + (trial_index or 0)
    base_name = cfg.path.expname
    new_name = re.sub(r"param_\d+_1", f"param_{trial_num}_1", base_name)
    if new_name == base_name:
        new_name = f"{base_name.split('param_')[0]}param_{trial_num}_1"
    cfg.path.expname = new_name
    return cfg


def _variant_space(cfg: AVRConfig, trial: Trial, variant: str) -> None:
    ch = cfg.model.channel_embed
    if variant in ("ch", "ch_without_das"):
        ch.is_embed = trial.suggest_categorical("is_embed", [True, False])
        if ch.is_embed:
            ch.connection_type = trial.suggest_categorical(
                "connection_type", ["add", "concat"]
            )
            ch.is_sigma_encoder = trial.suggest_categorical("is_sigma_encoder", [True, False])
            ch.is_sigma_decoder = trial.suggest_categorical("is_sigma_decoder", [True, False])
            ch.is_signal_network = trial.suggest_categorical("is_signal_network", [True, False])
            ch.emb_dim_sigma_encoder = 2 ** trial.suggest_int("emb_dim_sigma_encoder", 2, 6)
            ch.emb_dim_sigma_decoder = 2 ** trial.suggest_int("emb_dim_sigma_decoder", 2, 6)
            ch.emb_dim_signal_network = 2 ** trial.suggest_int("emb_dim_signal_network", 2, 6)
    if variant == "ch":
        cfg.train.das_reg_loss_weight = trial.suggest_float(
            "das_reg_loss_weight", 0.0, 100.0
        )
    elif variant == "ch_only_das":
        cfg.train.das_reg_loss_weight = trial.suggest_float(
            "das_reg_loss_weight", 0.0, 100.0
        )
        cfg.train.das_ce_loss_weight = trial.suggest_float(
            "das_ce_loss_weight", 0.0, 100.0
        )
    elif variant == "das":
        cfg.train.das_reg_loss_weight = trial.suggest_float(
            "das_reg_loss_weight", 1.0, 100.0, log=True
        )
        cfg.train.das_ce_loss_weight = trial.suggest_float(
            "das_ce_loss_weight", 1.0, 100.0, log=True
        )
        dim = 2 ** trial.suggest_int("emb_dim", 2, 6)
        ch.is_embed = True
        ch.connection_type = "concat"
        ch.is_sigma_encoder = ch.is_sigma_decoder = ch.is_signal_network = True
        ch.emb_dim_sigma_encoder = ch.emb_dim_sigma_decoder = ch.emb_dim_signal_network = dim


def doa_objective_from_logdir(logdir: str, fs: int, return_curve: bool = False):
    """min over checkpoints of mean NormMUSIC pred-vs-gt error
    (reference/optuna_avr_runner.py:96-124); 999 when nothing usable.
    With return_curve, also returns {iteration: mean error} per
    checkpoint (single source for the objective AND its curve)."""
    npz_dir = os.path.join(logdir, "val_result")
    doa_dir = os.path.join(logdir, "doa_results")
    os.makedirs(doa_dir, exist_ok=True)
    curve: dict = {}
    if os.path.isdir(npz_dir):
        files = sorted(
            (f for f in os.listdir(npz_dir) if re.match(r"val_iter\d+\.npz", f)),
            key=lambda x: int(re.findall(r"\d+", x)[0]),
        )
        for name in files:
            pkl = os.path.join(doa_dir, os.path.splitext(name)[0] + ".pkl")
            if not os.path.exists(pkl):
                run_doa_on_npz(
                    os.path.join(npz_dir, name), fs=fs,
                    algo_names=["NormMUSIC"], save_path=pkl,
                )
            with open(pkl, "rb") as f:
                res = pickle.load(f)
            clean = [e for e in res["NormMUSIC"]["pred_vs_gt_error"]
                     if e is not None]
            if clean:
                curve[int(re.findall(r"\d+", name)[0])] = float(np.mean(clean))
    best = min(curve.values()) if curve else 999.0
    return (best, curve) if return_curve else best


def make_objective(base_cfg: AVRConfig, dataset_dir: str, start_index: int,
                   variant: str = "base", runner_cls=None, device="cuda"):
    """Build the study objective (trial → DoA error); trials train on ``device``."""
    from avr_torch.train.runner import AVRRunner

    runner_cls = runner_cls or AVRRunner

    def objective(trial: Trial) -> float:
        cfg = update_config(base_cfg, start_index, trial.number, trial, variant)
        logdir = os.path.join(cfg.path.logdir, cfg.path.expname)
        os.makedirs(logdir, exist_ok=True)
        cfg.to_yaml(os.path.join(logdir, f"avr_conf_trial_{trial.number}.yml"))
        runner = runner_cls(cfg, dataset_dir, batch_size=cfg.train.batch_size, device=device)
        runner.train()
        return doa_objective_from_logdir(logdir, cfg.render.fs)

    return objective


def main(argv=None):
    """CLI mirroring optuna_avr_runner.py:141-164; ``--pop K`` trains K
    runtime-variant trials at a time as one population
    (``hpo/population.run_population_study``)."""
    import argparse

    p = argparse.ArgumentParser(prog="avr_torch hpo", description="avr_torch HPO")
    p.add_argument("--config", required=True)
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--start_index", type=int, default=0)
    p.add_argument("--n_trials", type=int, default=10)
    p.add_argument("--study_name", default="avr_torch_study")
    p.add_argument("--storage", default=None)
    p.add_argument("--variant", default="base",
                   choices=["base", "ch", "ch_without_das", "ch_only_das", "das", "runtime"])
    p.add_argument("--pop", type=int, default=0,
                   help="population size K: train K runtime-variant trials per step "
                        "(requires --variant runtime)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    if args.pop and args.variant != "runtime":
        p.error("--pop requires --variant runtime (trial identity must be a runtime-hparam bundle)")

    base_cfg = AVRConfig.from_yaml(args.config)
    study = create_study(args.study_name, args.storage)
    if args.pop:
        from avr_torch.hpo.population import run_population_study

        run_population_study(study, base_cfg, args.dataset_dir, args.n_trials, args.pop,
                             start_index=args.start_index, device=args.device)
    else:
        # one crashing trial (OOM, NaN'd objective, bad config combo) is
        # recorded as FAIL and the study continues — an overnight 50-trial
        # study must not die on trial 3
        study.optimize(
            make_objective(base_cfg, args.dataset_dir, args.start_index, args.variant,
                           device=args.device),
            n_trials=args.n_trials,
            catch=(Exception,),
        )
    print("best:", study.best_value, study.best_params)


if __name__ == "__main__":
    main()
