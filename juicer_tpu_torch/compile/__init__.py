from .gram import arpa_grammar

__all__ = ["arpa_grammar"]
