from .models import AcousticModelSet, FlatGmmParams

__all__ = ["AcousticModelSet", "FlatGmmParams"]
