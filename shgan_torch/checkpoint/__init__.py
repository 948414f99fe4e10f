from .convert import load_pth, params_from_jax
from .snapshot import load_network_snapshot, tf_params_to_torch_state_dict
from .torch_writer import save_torch_pth

__all__ = ["load_pth", "params_from_jax", "load_network_snapshot",
           "tf_params_to_torch_state_dict", "save_torch_pth"]
