"""Offline WFST compilation: G, L, C and H generation and the CLG build
pipeline (a copy of `juicer_tpu/compile/`)."""

from .cd import CDGen, CDPhoneLookup, CDType
from .gram import GramGen, GramType, arpa_grammar
from .hmm2fst import HmmGen
from .lex import LexGen
from .pipeline import aux_to_eps, build_clg

__all__ = ["CDGen", "CDPhoneLookup", "CDType", "GramGen", "GramType", "HmmGen", "LexGen",
           "arpa_grammar", "aux_to_eps", "build_clg"]
