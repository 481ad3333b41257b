from .interp import grid_value_deriv

__all__ = ["grid_value_deriv"]
