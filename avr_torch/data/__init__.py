"""Host-side data pipeline (numpy): synthetic dataset writers, loaders for
the four reference formats, and the batch sampler. Port of
``avr_tpu/data``."""

from avr_torch.data.loaders import Dataset, load_dataset  # noqa: F401
from avr_torch.data.sampler import BatchSampler  # noqa: F401
