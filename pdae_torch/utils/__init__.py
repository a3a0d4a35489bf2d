from .convert import (encoder_state_dict, encoder_tree, train_state_tensors,
                      train_state_trees, unet_state_dict, unet_tree)
from .image import from_uint8, to_uint8

__all__ = ["encoder_state_dict", "unet_state_dict", "encoder_tree", "unet_tree",
           "train_state_tensors", "train_state_trees", "from_uint8", "to_uint8"]
