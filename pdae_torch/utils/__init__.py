from .convert import encoder_state_dict, unet_state_dict
from .image import from_uint8, to_uint8

__all__ = ["encoder_state_dict", "unet_state_dict", "from_uint8", "to_uint8"]
