from .mmf import MMFParseError, parse_mmf, write_mmf
from .models import AcousticModelSet, FlatGmmParams

__all__ = ["AcousticModelSet", "FlatGmmParams", "MMFParseError", "parse_mmf", "write_mmf"]
