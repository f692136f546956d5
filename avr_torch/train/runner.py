"""Training loop (port of ``avr_tpu/train/runner.py``).

Responsibilities, as in the JAX runner (after reference/avr_runner.py:25-372):
  * dataset loading per config, train/test samplers;
  * the train step (Adam + cosine schedule + clip + NaN guards) on the
    device the caller names (``"cuda"`` by default; the CPU runs the
    kernels' plain versions);
  * scalar logging every ``log_freq`` iterations ('train_loss',
    'train_loss_terms/*', 'samples_per_sec', 'learning rate') to JSONL
    (and TensorBoard where tensorboardX imports);
  * checkpoints every ``save_freq`` with ``torch.save`` in place of orbax:
    ``{logdir}/ckpts/{step}/state.pt`` holds ``params``, ``mu``, ``nu``
    and ``step`` as CPU tensors in the params' tree, written under a
    temporary name and renamed when complete; the 5 newest are kept, and
    ``load_checkpoint`` restores onto the runner's device, whatever device
    wrote them;
  * validation every ``val_freq``: render the split with fixed eval
    directions, the criterion and the numpy metrics (+ stds) under
    {mode}_loss/ {mode}_metric/ {mode}_metric_std/, and
    ``val_result/val_iter{it:06d}.npz`` with the keys
    ori_sig/pred_sig/position_rx/position_tx/fs[/ch_idx] that the DoA
    suite reads (avr_runner.py:278-302).

Several devices (``mesh_plan``, ``parallel.mesh``): one process per device,
every rank with the same sampler seed, so the same global batches and
directions; the step splits them over the (data, ray) plan. Rank 0 alone
writes the log, the metrics, the config backup, figures, ``val_result``
npz files and checkpoints; a barrier follows each save, and every rank
loads a checkpoint from the shared log directory. The fresh state is rank
0's, broadcast.

Random numbers: torch cannot draw JAX's. The training directions of
iteration ``it`` come from a generator seeded from (train.seed + 1, it)
alone, the counterpart of ``fold_in(key, it)``, so a resumed run draws the
same directions; the eval directions from a generator seeded with
``eval_seed``. Parity tests hand JAX's directions to ``render_dataset`` and
``validate`` instead.
"""

from __future__ import annotations

import itertools
import logging
import os
import shutil
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from avr_torch import geometry
from avr_torch.config import AVRConfig
from avr_torch.data.loaders import Dataset, load_dataset
from avr_torch.data.sampler import BatchSampler
from avr_torch.device import resolve_device
from avr_torch.losses import CriterionConfig, LossBundle, criterion
from avr_torch.metrics import metric_cal
from avr_torch.models import field as field_lib
from avr_torch.parallel.mesh import MeshPlan
from avr_torch.render.common import make_consts
from avr_torch.train.state import (
    AdamState, TrainState, broadcast_state, current_lr, init_state, make_train_step, named_leaves,
    tree_map,
)
from avr_torch.utils.logging import MetricsWriter, configure_logger

METRIC_KEYS = ("Angle", "Amplitude", "Envelope", "T60", "C50", "EDT", "multi_stft")
_METRIC_FIELDS = dict(zip(METRIC_KEYS, (
    "angle_error", "amp_error", "env_error", "t60_error", "c50_error", "edt_error", "multi_stft",
)))
EVAL_SEED = 1234
CHECKPOINT_FILE = "state.pt"
KEEP_CHECKPOINTS = 5
TRAIN_VAL_BATCHES = 15  # capped train-split validation (reference/avr_runner.py:322-370)


def device_batch(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A sampler's numpy batch as tensors on ``device`` (channels as int64 indices)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    if "ch_idx" in out:  # int32 from the sampler; indices are int64
        out["ch_idx"] = out["ch_idx"].long()
    return out


def iteration_generator(seed: int, it: int, device: torch.device) -> torch.Generator:
    """Iteration ``it``'s direction generator, from (seed + 1, it) alone."""
    g_seed = (((seed + 1) & 0xFFFFFFFF) << 32) | (it & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(g_seed)


def eval_directions(rc, device: torch.device, eval_seed: int = EVAL_SEED) -> torch.Tensor:
    """The fixed eval ray directions [R, 3] of ``eval_seed``."""
    gen = torch.Generator(device=device).manual_seed(eval_seed)
    return geometry.ray_directions(rc.n_azi, rc.n_ele, generator=gen, device=device)


class _NoWriter:
    """The metrics writer of a rank other than 0: writes nothing."""

    def scalar(self, *args, **kwargs) -> None:
        pass

    scalars = flush = close = scalar


class AVRRunner:
    def __init__(
        self,
        cfg: AVRConfig,
        dataset_dir: Optional[str],
        batch_size: Optional[int] = None,
        train_data: Optional[Dataset] = None,
        test_data: Optional[Dataset] = None,
        memory_check: bool = False,
        device="cuda",
        mesh_plan: Optional[MeshPlan] = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size or cfg.train.batch_size
        self.memory_check = memory_check
        self.mesh_plan = mesh_plan
        self.is_main = mesh_plan is None or mesh_plan.rank == 0
        self.logdir = os.path.join(cfg.path.logdir, cfg.path.expname)
        if self.is_main:
            os.makedirs(self.logdir, exist_ok=True)
            self.logger = configure_logger(self.logdir)
            self.writer = MetricsWriter(self.logdir)
            cfg.to_yaml(os.path.join(self.logdir, "avr_conf.yml"))  # config backup
            # invocation audit (reference/avr_runner.py:441-446)
            with open(os.path.join(self.logdir, "command_log.txt"), "a") as f:
                f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {' '.join(sys.argv)}\n")
        else:
            self.logger = configure_logger("", name=f"avr_torch.rank{mesh_plan.rank}")
            self.logger.setLevel(logging.WARNING)
            self.writer = _NoWriter()

        seq_len = cfg.model.signal_output_dim
        dt = cfg.path.dataset_type
        self.train_data = train_data if train_data is not None else load_dataset(
            dataset_dir, dt, eval=False, seq_len=seq_len, fs=cfg.render.fs
        )
        self.test_data = test_data if test_data is not None else load_dataset(
            dataset_dir, dt, eval=True, seq_len=seq_len, fs=cfg.render.fs
        )
        self.logger.info(
            "dataset %s: %d train / %d test", dt, len(self.train_data), len(self.test_data)
        )

        group8 = bool(
            cfg.train.das_reg_loss_weight > 0 or cfg.train.das_ce_loss_weight > 0
        ) and bool(cfg.train.extra.get("group_sampling", False))
        self.train_sampler = BatchSampler(
            self.train_data, self.batch_size, shuffle=True, seed=cfg.train.seed,
            jitter=True, group8=group8,
        )

        self.fstatic = field_lib.build_field(cfg.model, dt)
        self.consts = make_consts(cfg.render, seq_len, device=self.device)
        self.crit = CriterionConfig.from_configs(cfg.train, cfg.render)
        gen = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.state = init_state(gen, self.fstatic, cfg.train, device=self.device)
        if mesh_plan is not None:
            self.state = broadcast_state(self.state)
        # With train.runtime_hparams the step takes the JAX package's
        # runtime-scalar program: its rate formula (cosine_lr_hp), which
        # rounds differently from the static schedule, and an always-added
        # weight decay.
        self._step_fn, self._render_fn = make_train_step(
            self.fstatic, self.consts, cfg.render, cfg.train, self.crit, mesh_plan=mesh_plan
        )
        self._figures_warned = False
        self._ckpt_dir = os.path.join(os.path.abspath(self.logdir), "ckpts")
        if cfg.train.load_ckpt:
            self.load_checkpoint()

    # ------------------------------------------------------------------
    def checkpoint_steps(self):
        """Steps with a complete checkpoint, ascending."""
        if not os.path.isdir(self._ckpt_dir):
            return []
        return sorted(
            int(n) for n in os.listdir(self._ckpt_dir)
            if n.isdigit() and os.path.exists(os.path.join(self._ckpt_dir, n, CHECKPOINT_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.checkpoint_steps()
        return steps[-1] if steps else None

    def save_checkpoint(self) -> int:
        """Write the state at its step (once per step, as orbax) and keep
        the KEEP_CHECKPOINTS newest. Synchronous: the file is complete when
        this returns, on every rank (rank 0 writes, then all wait)."""
        step = int(self.state.step)
        if self.is_main:
            self._write_checkpoint(step)
        if self.mesh_plan is not None:
            torch.distributed.barrier()
        return step

    def _write_checkpoint(self, step: int) -> None:
        step_dir = os.path.join(self._ckpt_dir, str(step))
        path = os.path.join(step_dir, CHECKPOINT_FILE)
        if os.path.exists(path):
            return
        os.makedirs(step_dir, exist_ok=True)

        def host(tree):
            return tree_map(lambda t: t.detach().cpu(), tree)

        payload = {
            "params": host(self.state.params), "mu": host(self.state.opt_state.mu),
            "nu": host(self.state.opt_state.nu), "step": self.state.step.detach().cpu(),
        }
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.checkpoint_steps()[:-KEEP_CHECKPOINTS]:
            shutil.rmtree(os.path.join(self._ckpt_dir, str(old)))

    def load_checkpoint(self, step: Optional[int] = None) -> bool:
        step = step if step is not None else self.latest_step()
        if step is None:
            self.logger.info("no checkpoint to resume from")
            return False
        path = os.path.join(self._ckpt_dir, str(step), CHECKPOINT_FILE)
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        want = [(n, tuple(t.shape)) for n, t in named_leaves(self.state.params)]
        got = [(n, tuple(t.shape)) for n, t in named_leaves(ckpt["params"])]
        if got != want:
            bad = next((g, w) for g, w in itertools.zip_longest(got, want) if g != w)
            raise ValueError(f"checkpoint {path} does not fit this model: (leaf, shape) {bad[0]} != {bad[1]}")
        self.state = TrainState(ckpt["params"], AdamState(ckpt["mu"], ckpt["nu"]), ckpt["step"])
        self.logger.info("resumed from checkpoint step %d", int(self.state.step))
        return True

    # ------------------------------------------------------------------
    def train(self) -> None:
        tc = self.cfg.train
        if len(self.train_sampler) == 0:
            raise ValueError(
                f"train: {len(self.train_data)} training rows make no batch of {self.batch_size}"
            )
        it = int(self.state.step)
        self.logger.info("start training at step %d", it)
        t_last = time.time()
        host_it = it
        K = max(1, tc.steps_per_call)
        pending: list = []
        while it < tc.total_iterations:
            for batch in self.train_sampler.epoch():
                pending.append(batch)
                if len(pending) < K:
                    continue
                # K optimizer steps per host iteration, inner step k keyed
                # it0 + k: the port's counterpart of the JAX runner's lax.scan.
                for b in pending:
                    host_it += 1
                    self.state, bundle = self._step_fn(
                        self.state, device_batch(b, self.device),
                        iteration_generator(tc.seed, host_it, self.device),
                    )
                pending = []
                it_prev, it = it, int(self.state.step)  # the iteration's one sync

                # boundary-crossing checks (robust when steps_per_call > 1
                # advances `it` by more than one per iteration)
                def crossed(freq: int) -> bool:
                    return it // freq > it_prev // freq

                if crossed(tc.log_freq):
                    # the last inner step's bundle, fetched from the device in one copy
                    vals = torch.stack(list(bundle)).cpu().numpy()
                    self.writer.scalar("train_loss", float(np.sum(vals)), it)
                    self.writer.scalars(
                        dict(zip(LossBundle._fields, map(float, vals))), it, prefix="train_loss_terms/",
                    )
                    rate = tc.log_freq * self.batch_size / max(time.time() - t_last, 1e-9)
                    self.writer.scalar("samples_per_sec", rate, it)
                    self.writer.scalar("learning rate", current_lr(tc, it), it)
                    t_last = time.time()
                if self.memory_check and self.is_main and crossed(tc.log_freq):
                    # instrumented mode (reference/avr_runner_memory_check.py)
                    from avr_torch.utils import profiling

                    profiling.log_memory(f"iter{it}", self.logger)
                    profiling.memory_snapshot(
                        os.path.join(self.logdir, f"memory_snapshot_{it:08d}.json")
                    )
                if crossed(tc.save_freq) and it > 0:
                    self.logger.info("saved checkpoint at step %d", self.save_checkpoint())
                if crossed(tc.val_freq) and it > 0:
                    self.validate(it)
                    self.validate(it, mode_set="train")
                if it >= tc.total_iterations:
                    break
        self.save_checkpoint()  # final checkpoint
        self.writer.flush()

    # ------------------------------------------------------------------
    def eval_directions(self, eval_seed: int = EVAL_SEED) -> torch.Tensor:
        """The fixed eval ray directions [R, 3] of ``eval_seed``."""
        return eval_directions(self.cfg.render, self.device, eval_seed)

    def render_batch(self, batch: Dict[str, np.ndarray], dirs: torch.Tensor) -> np.ndarray:
        """Spectra complex64 [bs, F] of one numpy batch, without gradients."""
        with torch.no_grad():
            out = self._render_fn(self.state.params, device_batch(batch, self.device), dirs)
        out = out.cpu().numpy()
        return (out[..., 0] + 1j * out[..., 1]).astype(np.complex64)

    def render_dataset(
        self, data: Dataset, max_batches: Optional[int] = None, eval_seed: int = EVAL_SEED,
        dirs=None,
    ):
        """Render a dataset split with fixed directions: those of
        ``eval_seed``, or ``dirs`` [R, 3] when given. A trailing partial
        batch is padded to the batch size by repeating its last row, as the
        JAX runner does, so every call renders whole shares of the plan.

        Returns (pred complex64 [N, F], ori complex64 [N, F]).
        The reference renders eval batches with fresh random azimuth
        offsets per call (renderer.py:148-150 has no eval switch); fixed
        directions keep validation curves reproducible.
        """
        if dirs is None:
            dirs = self.eval_directions(eval_seed)
        dirs = torch.as_tensor(dirs, dtype=torch.float32, device=self.device)
        sampler = BatchSampler(data, self.batch_size, shuffle=False, jitter=False, drop_last=False)
        n_batches = len(sampler) if max_batches is None else min(len(sampler), max_batches)
        preds, oris = [], []
        bs = self.batch_size
        for batch in itertools.islice(sampler.epoch(), n_batches):
            n_real = batch["pos_rx"].shape[0]
            padded = {k: np.concatenate([v, np.repeat(v[-1:], bs - n_real, axis=0)]) for k, v in batch.items()}
            preds.append(self.render_batch(padded, dirs)[:n_real])
            wave = batch["wave"]
            oris.append((wave[..., 0] + 1j * wave[..., 1]).astype(np.complex64))
        return np.concatenate(preds), np.concatenate(oris)

    def validate(self, iteration: int, mode_set: str = "test", dirs=None) -> Dict[str, float]:
        """Loss and metrics of a split, logged; the test split's npz dump.
        ``dirs`` as in ``render_dataset``."""
        data = self.test_data if mode_set == "test" else self.train_data
        max_b = None if mode_set == "test" else TRAIN_VAL_BATCHES
        pred, ori = self.render_dataset(data, max_batches=max_b, dirs=dirs)

        # Host-side criterion on CPU fp32 tensors (the reference also
        # computes validation metrics host-side, avr_runner.py:260).
        # DAS losses beamform per 8-row group; truncate the eval set to
        # whole groups (the reference evaluates in group-sampled batches
        # of 8, avr_runner.py:378, so a trailing partial group never
        # reaches its criterion either).
        pred_l, ori_l = pred, ori
        if self.crit.das_reg_loss_weight > 0 or self.crit.das_ce_loss_weight > 0:
            g = self.crit.das_group_size
            n_whole = (len(pred_l) // g) * g
            if n_whole == 0:
                raise ValueError(
                    f"validate: the {mode_set} split has only "
                    f"{len(pred_l)} samples — fewer than one "
                    f"{g}-mic DAS group; losses would be NaN. Disable "
                    "the DAS loss weights or use a group-complete split."
                )
            if n_whole < len(pred_l):
                self.logger.info(
                    "validate: truncating %d -> %d samples for whole "
                    "%d-mic DAS groups", len(pred_l), n_whole, g,
                )
            pred_l, ori_l = pred_l[:n_whole], ori_l[:n_whole]

        def ri(x):
            return torch.from_numpy(np.stack([x.real, x.imag], -1))

        with torch.no_grad():
            bundle, ori_t, pred_t = criterion(ri(pred_l), ri(ori_l), self.crit)
        ori_t, pred_t = ori_t.numpy(), pred_t.numpy()
        losses = {
            "spec_loss": float(bundle.spec),
            "fft_loss": float(bundle.amplitude) + float(bundle.angle),
            "time_loss": float(bundle.time),
            "energy_loss": float(bundle.energy),
            "multi_stft_loss": float(bundle.multi_stft),
            "das_reg_loss": float(bundle.das_reg),
            "das_ce_loss": float(bundle.das_ce),
        }
        # metric_cal cap (host-side numpy, ~10 ms/sample); 0 = uncapped
        cap = int(getattr(self.cfg.train, "val_metric_cap", 256)) or len(pred_t)
        if cap < len(pred_t):
            self.logger.info(
                "validate: metric_cal over first %d of %d samples "
                "(train.val_metric_cap; 0 = all)", cap, len(pred_t),
            )
        per_sample = [
            metric_cal(ori_t[i : i + 1], pred_t[i : i + 1], fs=self.cfg.render.fs)
            for i in range(min(len(pred_t), cap))
        ]
        metrics = {
            k: float(np.nanmean([getattr(m, _METRIC_FIELDS[k]) for m in per_sample]))
            for k in METRIC_KEYS
        }
        stds = {
            k: float(np.nanstd([getattr(m, _METRIC_FIELDS[k]) for m in per_sample]))
            for k in METRIC_KEYS
        }
        self.writer.scalars(losses, iteration, prefix=f"{mode_set}_loss/")
        self.writer.scalars(metrics, iteration, prefix=f"{mode_set}_metric/")
        self.writer.scalars(stds, iteration, prefix=f"{mode_set}_metric_std/")
        self.logger.info(
            "val@%d %s", iteration, " ".join(f"{k}:{v:.4f}" for k, v in metrics.items()),
        )

        if mode_set == "test" and self.is_main:
            npz_dir = os.path.join(self.logdir, "val_result")
            os.makedirs(npz_dir, exist_ok=True)
            payload = dict(
                ori_sig=ori, pred_sig=pred,
                position_rx=data.pos_rx, position_tx=data.pos_tx,
                fs=self.cfg.render.fs,
            )
            if data.ch_idx is not None:
                payload["ch_idx"] = data.ch_idx
            np.savez_compressed(os.path.join(npz_dir, f"val_iter{iteration:06d}.npz"), **payload)
            self._dump_validation_figures(iteration, pred, ori, ori_t, pred_t, data)
        return metrics

    def _dump_validation_figures(self, iteration, pred, ori, ori_t, pred_t, data,
                                 max_figs: int = 15) -> None:
        """Per-sample prediction figures, ≤15 per validation
        (reference/avr_runner.py:271-276 → utils/logger.py:89-124), where
        matplotlib imports; without it one warning, and training goes on."""
        try:
            from avr_torch.utils import plotting
        except ImportError as e:
            if not self._figures_warned:
                self.logger.warning("validation figures skipped: %s", e)
                self._figures_warned = True
            return
        fig_dir = os.path.join(self.logdir, "figures", f"iter{iteration:06d}")
        os.makedirs(fig_dir, exist_ok=True)
        for i in range(min(max_figs, len(pred), len(pred_t))):
            try:
                plotting.plot_prediction_figure(
                    pred[i], ori[i], pred_t[i], ori_t[i],
                    data.pos_rx[i], data.pos_tx[i],
                    mode_set="test",
                    save_path=os.path.join(fig_dir, f"sample{i:03d}.png"),
                )
            except Exception as e:  # plotting must never kill training
                self.logger.warning("figure dump failed: %s", e)
                break


# ----------------------------------------------------------------------
def main(argv=None) -> None:
    """CLI mirroring `python avr_runner.py --mode train --config X.yml
    --dataset_dir D` (reference/avr_runner.py:419-424)."""
    import argparse

    p = argparse.ArgumentParser(description="avr_torch trainer")
    p.add_argument("--mode", default="train", choices=["train", "test"])
    p.add_argument("--config", required=True, help="config yml, or a logdir holding avr_conf.yml")
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--batchsize", type=int, default=None)
    p.add_argument("--memory_check", action="store_true",
                   help="log device memory + snapshots every log_freq iters")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--data_parallel", type=int, default=None,
                   help="ranks on the data axis of the plan (default: the largest power of two "
                        "dividing the world and the batch; the rest go to rays)")
    p.add_argument("--multihost", action="store_true",
                   help="accepted as the JAX CLI accepts it, and does nothing: a torchrun world "
                        "above 1 joins the process group, from torchrun's environment")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend (default nccl on CUDA, gloo on the CPU; gloo lets "
                        "several ranks share a device, a bare --device cuda then dealing the "
                        "local ranks round the host's devices)")
    args = p.parse_args(argv)

    device = args.device
    joins = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if joins:
        from avr_torch.parallel.mesh import initialize_multihost

        device = initialize_multihost(args.device, args.dist_backend)

    try:
        # test mode accepts a logdir: read its backed-up avr_conf.yml
        # (reference/avr_runner.py:430-432)
        config = args.config
        if os.path.isdir(config):
            config = os.path.join(config, "avr_conf.yml")
        cfg = AVRConfig.from_yaml(config)
        if args.mode == "test":
            # evaluate the TRAINED model even when the backed-up config was
            # written with load_ckpt: false
            cfg.train.load_ckpt = True
        plan = None
        if joins:
            from avr_torch.parallel.mesh import make_mesh_plan

            plan = make_mesh_plan(batch_size=args.batchsize or cfg.train.batch_size,
                                  data_parallel=args.data_parallel)
        runner = AVRRunner(cfg, args.dataset_dir, batch_size=args.batchsize,
                           memory_check=args.memory_check, device=device, mesh_plan=plan)
        if args.mode == "train":
            runner.train()
        else:
            runner.validate(int(runner.state.step))
    finally:
        if joins:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
