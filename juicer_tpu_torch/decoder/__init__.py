from .artifact import DecoderArtifact
from .autotune import autotune_budgets
from .core import TorchDecoder, TorchDecoderConfig
from .network import DecoderNetwork
from .otf import GNetwork, RefOtfDecoder
from .ref_core import RefDecoder
from .results import DecodeResult, WordHyp

__all__ = ["DecoderArtifact", "DecoderNetwork", "DecodeResult", "GNetwork", "RefDecoder", "RefOtfDecoder",
           "TorchDecoder", "TorchDecoderConfig", "WordHyp", "autotune_budgets"]
