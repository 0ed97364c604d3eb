from .arpa import ArpaLM

__all__ = ["ArpaLM"]
