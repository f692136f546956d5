"""Unified CLI: ``python -m avr_torch <command> ...`` (port of ``avr_tpu/__main__.py``).

Commands mirror the reference's per-script entry points:
  train      — avr_runner.py          (training / resume; --device;
               several devices: torchrun --nproc_per_node N -m avr_torch
               train ... [--data_parallel D] [--dist_backend nccl|gloo])
  render     — batch IR inference from a trained checkpoint (--device)
  doa        — plot_eval.run_doa_on_npz / DoA_val_res.py
  das        — plot_eval.run_delay_and_sum_on_npz
  rotate     — eval_rotate_doa_avr.py (--device)
  whitenoise — whitenoise_long_doa.py / whitenoise_bandpass_doa.py
  make-configs — make_config_for_control_exp.py
  synth      — synthetic shoebox dataset generation
  plot       — plot_loss.py / plot_DoA*.py / whitenoise_frame_* /
               doa_compare_stft_conditions.py / inspect_bandpass.py
  tools      — tools/meshrir_split.py, check_data.py
  hpo        — optuna_avr_runner*.py  (hyper-parameter search; --device;
               --pop K trains K runtime-variant trials as one population)

``--device`` defaults to ``cuda`` and raises without a CUDA device; pass
``--device cpu`` to run the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import sys


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    cmd, rest = argv[0], argv[1:]

    if cmd == "train":
        from avr_torch.train.runner import main as train_main

        train_main(rest)
    elif cmd in ("doa", "das"):
        import argparse
        import json

        from avr_torch.eval import doa

        p = argparse.ArgumentParser(prog=f"avr_torch {cmd}")
        p.add_argument("npz")
        p.add_argument("--fs", type=int, default=16000)
        p.add_argument("--n_fft", type=int, default=512)
        p.add_argument("--mic_radius", type=float, default=0.0365)
        p.add_argument("--algos", nargs="*", default=None)
        p.add_argument("--save", default=None)
        a = p.parse_args(rest)
        if cmd == "doa":
            res = doa.run_doa_on_npz(a.npz, a.fs, a.n_fft, a.mic_radius, a.algos, a.save)
        else:
            res = doa.run_delay_and_sum_on_npz(a.npz, a.fs, a.mic_radius, a.n_fft, save_path=a.save)
        print(json.dumps(doa.summarize(res), indent=2))
    elif cmd == "render":
        _render_cli(rest)
    elif cmd == "rotate":
        import argparse

        from avr_torch.config import AVRConfig
        from avr_torch.eval.rotate import make_render_fn, rotate_group_eval
        from avr_torch.train.runner import AVRRunner

        p = argparse.ArgumentParser(prog="avr_torch rotate")
        p.add_argument("--config", required=True)
        p.add_argument("--dataset_dir", required=True)
        p.add_argument("--deg_step", type=float, default=30.0)
        p.add_argument("--out_dir", default=None)
        p.add_argument("--device", default="cuda")
        a = p.parse_args(rest)
        cfg = AVRConfig.from_yaml(a.config)
        cfg.train.load_ckpt = True
        runner = AVRRunner(cfg, a.dataset_dir, device=a.device)
        out = a.out_dir or f"{runner.logdir}/rotate_eval_avr"
        rotate_group_eval(
            make_render_fn(runner),
            runner.test_data,
            cfg.render.xyz_min, cfg.render.xyz_max,
            cfg.render.fs, cfg.model.signal_output_dim,
            deg_step=a.deg_step, out_dir=out,
        )
        print(f"wrote {out}")
    elif cmd == "synth":
        import argparse

        from avr_torch.data import synthetic

        p = argparse.ArgumentParser(prog="avr_torch synth")
        p.add_argument("--out", required=True)
        p.add_argument("--format", default="Simu", choices=["Simu", "Real_env", "MeshRIR", "RAF"])
        p.add_argument("--n", type=int, default=100)
        p.add_argument("--fs", type=int, default=16000)
        p.add_argument("--seq_len", type=int, default=1600)
        p.add_argument("--seed", type=int, default=0)
        a = p.parse_args(rest)
        room = synthetic.RoomSpec(fs=a.fs, seq_len=a.seq_len)
        writer = {
            "Simu": synthetic.write_simu_dataset,
            "Real_env": synthetic.write_real_env_dataset,
            "MeshRIR": synthetic.write_meshrir_dataset,
            "RAF": synthetic.write_raf_dataset,
        }[a.format]
        if a.format == "Real_env":
            writer(a.out, room, n_groups=a.n, seed=a.seed)
        else:
            writer(a.out, room, n=a.n, seed=a.seed)
        print(f"wrote {a.format} dataset ({a.n}) to {a.out}")
    elif cmd == "tools":
        _tools_cli(rest)
    elif cmd == "hpo":
        from avr_torch.hpo.runner import main as hpo_main

        hpo_main(rest)
    elif cmd == "whitenoise":
        import argparse

        from avr_torch.eval.whitenoise import WhitenoiseConfig, run_whitenoise_eval

        p = argparse.ArgumentParser(prog="avr_torch whitenoise")
        p.add_argument("--config", required=True)
        p.add_argument("--force", action="store_true")
        a = p.parse_args(rest)
        cfg = WhitenoiseConfig.from_yaml(a.config)
        if a.force:
            cfg.force = True
        df = run_whitenoise_eval(cfg)
        print(df.head(10).to_string())
    elif cmd == "make-configs":
        import argparse

        import yaml

        from avr_torch.utils.config_tools import generate_param_variants

        p = argparse.ArgumentParser(prog="avr_torch make-configs")
        p.add_argument("--base_dir", required=True)
        p.add_argument("--params", required=True, help="YAML file of sweep dict")
        a = p.parse_args(rest)
        with open(a.params) as f:
            sweep = yaml.safe_load(f)
        for path in generate_param_variants(a.base_dir, sweep):
            print("wrote", path)
    elif cmd == "plot":
        _plot_cli(rest)
    else:
        print(f"unknown command {cmd!r}; run with --help")
        sys.exit(2)


def _render_cli(rest) -> None:
    """Render IRs from a trained checkpoint for an npz of queries."""
    import argparse
    import os

    import numpy as np

    from avr_torch.config import AVRConfig
    from avr_torch.data.loaders import Dataset
    from avr_torch.data.wav import write_wav
    from avr_torch.eval.rotate import make_render_fn
    from avr_torch.train.runner import AVRRunner

    p = argparse.ArgumentParser(
        prog="avr_torch render",
        description="Render IRs from a trained checkpoint for a list "
        "of (rx, tx[, ch_idx]) queries (npz with pos_rx [N,3], "
        "pos_tx [N,3], optional rot_tx [N,3]/ch_idx [N]).",
    )
    p.add_argument("--config", required=True, help="training config or logdir avr_conf.yml")
    p.add_argument("--queries", required=True, help="npz of positions")
    p.add_argument("--out", required=True, help="output npz path")
    p.add_argument("--batch", type=int, default=None,
                   help="queries per render call (default: train batch size)")
    p.add_argument("--time_domain", action="store_true",
                   help="also store irfft waveforms under key 'ir'")
    p.add_argument("--wav_dir", default=None, help="additionally write one WAV per query")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(rest)
    cfg = AVRConfig.from_yaml(a.config)
    cfg.train.load_ckpt = True
    q = np.load(a.queries)
    missing = [k for k in ("pos_rx", "pos_tx") if k not in q.files]
    if missing:
        sys.exit(
            f"queries npz {a.queries} is missing required key(s) "
            f"{missing} (has {q.files}); need pos_rx [N,3] and pos_tx [N,3]"
        )
    n = q["pos_rx"].shape[0]
    if n == 0:
        sys.exit(f"queries npz {a.queries} has zero rows — nothing to render")
    if q["pos_tx"].shape[0] != n:
        sys.exit(f"pos_rx has {n} rows but pos_tx has {q['pos_tx'].shape[0]}")
    # inference needs no dataset: stub both splits with the queries
    # (zero targets) so the runner only supplies params + render fn
    F_bins = cfg.model.signal_output_dim // 2 + 1
    stub = Dataset(
        wave=np.zeros((n, F_bins), np.complex64),
        pos_rx=np.asarray(q["pos_rx"], np.float32),
        pos_tx=np.asarray(q["pos_tx"], np.float32),
        rot_tx=np.asarray(q["rot_tx"], np.float32) if "rot_tx" in q else None,
        ch_idx=np.asarray(q["ch_idx"], np.int32) if "ch_idx" in q else None,
        dataset_type=cfg.path.dataset_type,
        fs=cfg.render.fs, seq_len=cfg.model.signal_output_dim,
    )
    # inference never needs the DAS group-8 sampling invariant
    cfg.train.extra["group_sampling"] = False
    runner = AVRRunner(cfg, None, train_data=stub, test_data=stub, device=a.device)
    if runner.latest_step() is None:
        sys.exit(
            f"no checkpoint under {runner.logdir}/ckpts — refusing to "
            "render from randomly-initialized parameters"
        )
    render_fn = make_render_fn(runner)
    bs = a.batch or cfg.train.batch_size

    def batch_slice(arr, s):
        """Slice [s:s+bs], padding a trailing partial batch by repeating
        its last row, so that every call renders one batch shape."""
        part = arr[s : min(s + bs, n)]
        if part.shape[0] < bs:
            part = np.concatenate([part, np.repeat(part[-1:], bs - part.shape[0], axis=0)], axis=0)
        return part

    specs = []
    for s in range(0, n, bs):
        kw = {k: batch_slice(q[k], s) for k in ("ch_idx", "rot_tx") if k in q}
        specs.append(render_fn(batch_slice(q["pos_rx"], s), batch_slice(q["pos_tx"], s), **kw))
    spec = np.concatenate(specs, axis=0)[:n]  # [N, F] complex64
    out = {"spec": spec, "pos_rx": q["pos_rx"], "pos_tx": q["pos_tx"], "fs": cfg.render.fs}
    if a.time_domain or a.wav_dir:
        ir = np.fft.irfft(spec, n=cfg.model.signal_output_dim, axis=-1).astype(np.float32)
        if a.time_domain:
            out["ir"] = ir
        if a.wav_dir:
            os.makedirs(a.wav_dir, exist_ok=True)
            peak = max(float(np.abs(ir).max()), 1e-9)
            for i in range(n):
                write_wav(os.path.join(a.wav_dir, f"ir_{i:05d}.wav"), ir[i] / peak, cfg.render.fs)
    np.savez(a.out, **out)
    print(f"rendered {n} IRs -> {a.out}")


def _plot_cli(rest) -> None:
    """Reporting subcommands over training logs / eval pickles."""
    import argparse
    import json
    import pickle

    p = argparse.ArgumentParser(prog="avr_torch plot")
    p.add_argument("kind", choices=[
        "loss", "loss-epoch", "doa-scatter", "doa-detail", "das-detail",
        "frame-errors", "frame-scatter",
        "stft-compare", "band-response", "median-summary",
        "waveform-level", "rotate", "report",
    ])
    p.add_argument("inputs", nargs="+",
                   help="metrics.jsonl / tfevents file / logdir / doa "
                        "pickle / condition pickles / val npz / results "
                        "dir (per kind)")
    p.add_argument("--save", required=True)
    p.add_argument("--prefixes", nargs="*", default=["train_loss"])
    p.add_argument("--fs", type=int, default=16000)
    a = p.parse_args(rest)

    from avr_torch.eval import aggregators
    from avr_torch.utils import plotting

    if a.kind == "loss":
        plotting.plot_loss_curves(a.inputs[0], a.save, a.prefixes)
    elif a.kind == "loss-epoch":
        plotting.plot_loss_by_epoch(a.inputs[0], a.save)
    elif a.kind == "doa-detail":
        print(aggregators.plot_doa_detail_scatter(a.inputs[0], a.save))
    elif a.kind == "das-detail":
        print(aggregators.plot_das_detail_scatter(a.inputs[0], a.save))
    elif a.kind == "doa-scatter":
        with open(a.inputs[0], "rb") as f:
            plotting.plot_doa_scatter(pickle.load(f), a.save)
    elif a.kind == "frame-errors":
        aggregators.plot_frame_errors(a.inputs, a.save)
    elif a.kind == "frame-scatter":
        aggregators.plot_frame_scatter(a.inputs[0], a.save)
    elif a.kind == "stft-compare":
        # The JAX CLI passes save_path=, which compare_stft_conditions
        # does not take (TypeError); the port writes the CSV to --save.
        df = aggregators.compare_stft_conditions(a.inputs, fs=a.fs, save_csv=a.save)
        print(df.to_string())
    elif a.kind == "band-response":
        aggregators.plot_band_response(a.inputs[0], a.save, fs=a.fs)
    elif a.kind == "median-summary":
        df = aggregators.circular_median_summary(a.inputs[0])
        df.to_csv(a.save, index=False)
        print(json.dumps({"rows": len(df), "csv": a.save}))
    elif a.kind == "waveform-level":
        df = aggregators.waveform_level_summary(a.inputs[0], a.save)
        print(df.groupby("reduction")[["pred_vs_true", "pred_vs_gt"]].mean().to_string())
    elif a.kind == "rotate":
        aggregators.plot_rotate_results(a.inputs[0], a.save)
    elif a.kind == "report":
        doa_by_iter = aggregators.experiment_report(a.inputs[0], save_path=a.save)
        print(json.dumps({str(k): v for k, v in sorted(doa_by_iter.items())}, indent=2))
    print(f"wrote {a.save}")


def _tools_cli(rest) -> None:
    """Dataset utilities (reference/tools/meshrir_split.py, check_data.py)."""
    import argparse
    import json

    from avr_torch.data import tools

    p = argparse.ArgumentParser(prog="avr_torch tools")
    p.add_argument("kind", choices=["meshrir-split", "inspect"])
    p.add_argument("path")
    p.add_argument("--test_ratio", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(rest)

    if a.kind == "meshrir-split":
        train, test = tools.meshrir_split(a.path, test_frac=a.test_ratio, seed=a.seed)
        print(json.dumps({"train": len(train), "test": len(test)}))
    else:
        info = tools.inspect_npz(a.path) if a.path.endswith(".npz") else tools.inspect_npy(a.path)
        print(json.dumps(info, indent=2, default=str))


if __name__ == "__main__":
    main()
