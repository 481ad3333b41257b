from .errors import EDMError, edm_error
from .checkpoint import load_state, save_state

__all__ = ["EDMError", "edm_error"]
