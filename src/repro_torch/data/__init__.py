"""Training data: the port's copies of ``repro.data`` (numpy batches)."""

from repro_torch.data.pipeline import BinTokenDataset, PrefetchIterator  # noqa: F401
from repro_torch.data.synthetic import SyntheticLM, make_synthetic  # noqa: F401
