from .arpa import ArpaLM
from .wordpair import WordPairLM

__all__ = ["ArpaLM", "WordPairLM"]
