"""Hyper-parameter search: the study engine, the trial driver and population training."""

from avr_torch.hpo.study import Study, Trial, create_study  # noqa: F401
