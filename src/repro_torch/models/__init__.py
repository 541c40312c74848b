"""The language model's serving path: the attention-family blocks of
``repro.models`` (``PORTED_KINDS``) and ``LanguageModel``."""

from repro_torch.models.blocks import PORTED_KINDS, check_ported  # noqa: F401
from repro_torch.models.lm import LanguageModel  # noqa: F401
