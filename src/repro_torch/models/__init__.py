"""The language model: the block kinds of ``repro.models`` and
``LanguageModel``."""

from repro_torch.models.lm import LanguageModel  # noqa: F401
