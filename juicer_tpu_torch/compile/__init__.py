from .gram import GramGen, GramType, arpa_grammar

__all__ = ["GramGen", "GramType", "arpa_grammar"]
