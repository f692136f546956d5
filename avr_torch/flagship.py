"""The flagship workload: RAF-Furnished-shaped complex field.

Port of ``__graft_entry__._flagship_config`` (reference/config_files/
avr_raf_furnished.yml:16-44): 36×18+2 = 650 rays, 32 samples, a 1600-tap
IR at 16 kHz, the complex field variant with six hash encodings of
20 levels × 2^18 rows in ``hybridc:7`` interpolation (trilinear on the 7
coarsest levels, Kuhn simplex above). The interpolation mode is fixed
here; the JAX entry's environment override is not ported.
"""

from __future__ import annotations

from avr_torch.config import (
    AVRConfig,
    EncodingConfig,
    MLPConfig,
    PathConfig,
    TrainConfig,
)


def flagship_config(small: bool = False) -> AVRConfig:
    """The flagship config; ``small`` shrinks every width for quick runs
    (``hybridc:2`` keeps the mixed-mode encode exercised at 4 levels)."""
    cfg = AVRConfig()
    cfg.path = PathConfig(expname="raf_furnished", dataset_type="RAF", logdir="logs/raf")
    rc = cfg.render
    rc.xyz_min, rc.xyz_max = [-12.0] * 3, [12.0] * 3
    rc.near, rc.far = 0.0, 6.0
    rc.n_samples = 4 if small else 32
    rc.n_azi, rc.n_ele = (6, 3) if small else (36, 18)
    rc.speed, rc.fs, rc.pathloss = 346.8, 16000, 0.5
    cfg.model.signal_output_dim = 128 if small else 1600
    cfg.model.leaky_relu = 0.03
    enc = EncodingConfig(
        n_levels=4 if small else 20,
        log2_hashmap_size=8 if small else 18,
        base_resolution=4 if small else 16,
        per_level_scale=1.5 if small else 2.0,
        interpolation="hybridc:2" if small else "hybridc:7",
    )
    for name in (
        "pos_encoding_sigma", "tx_pos_encoding_sigma", "pos_encoding_sig",
        "tx_pos_encoding_sig", "dir_encoding_sig", "tx_dir_encoding_sig",
    ):
        setattr(cfg.model, name, enc)
    cfg.model.sigma_encoder_network = MLPConfig(
        n_neurons=32 if small else 128, n_hidden_layers=3
    )
    cfg.model.sigma_decoder_network = MLPConfig(
        n_neurons=32 if small else 128, n_hidden_layers=1
    )
    cfg.model.signal_network = MLPConfig(
        n_neurons=32 if small else 512, n_hidden_layers=2 if small else 4
    )
    cfg.train = TrainConfig(
        lr=2e-4, eta_min=8e-5, T_max=300_000, total_iterations=80_000,
        batch_size=4, shell_chunk=8,
    )
    return cfg
