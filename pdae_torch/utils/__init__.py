from .convert import (classifier_state_dict, classifier_tree, encoder_state_dict,
                      encoder_tree, mlp_skip_net_state_dict, mlp_skip_net_tree,
                      train_state_tensors, train_state_trees, unet_state_dict, unet_tree)
from .image import from_uint8, to_uint8

__all__ = ["encoder_state_dict", "unet_state_dict", "mlp_skip_net_state_dict",
           "classifier_state_dict", "encoder_tree", "unet_tree", "mlp_skip_net_tree",
           "classifier_tree", "train_state_tensors", "train_state_trees",
           "from_uint8", "to_uint8"]
