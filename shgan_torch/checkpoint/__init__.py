from .convert import load_pth, params_from_jax

__all__ = ["load_pth", "params_from_jax"]
