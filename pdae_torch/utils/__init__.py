from .checkpoint import (checkpoint_paths, load_checkpoint, merge_partial,
                         restore_into, save_checkpoint, snapshot_path)
from .config import (apply_overrides, load_yaml, overlay_eval_dataset_config,
                     parse_adam_betas, save_yaml)
from .convert import (classifier_state_dict, classifier_tree, encoder_state_dict,
                      encoder_tree, mlp_skip_net_state_dict, mlp_skip_net_tree,
                      optimizer_moments, optimizer_tree, train_state_tensors,
                      train_state_trees, unet_state_dict, unet_tree)
from .image import (from_uint8, make_grid, paste_rows, save_image_grid, to_uint8,
                    write_png)
from .rng import BASE_SEED, stream_seed
from .sharded_checkpoint import (is_sharded_checkpoint, load_sharded_checkpoint,
                                 save_sharded_checkpoint)

__all__ = ["checkpoint_paths", "load_checkpoint", "merge_partial", "restore_into",
           "save_checkpoint", "snapshot_path", "apply_overrides", "load_yaml",
           "overlay_eval_dataset_config", "parse_adam_betas", "save_yaml",
           "encoder_state_dict", "unet_state_dict", "mlp_skip_net_state_dict",
           "classifier_state_dict", "encoder_tree", "unet_tree", "mlp_skip_net_tree",
           "classifier_tree", "optimizer_moments", "optimizer_tree",
           "train_state_tensors", "train_state_trees", "from_uint8", "make_grid",
           "paste_rows", "save_image_grid", "to_uint8", "write_png", "BASE_SEED", "stream_seed",
           "is_sharded_checkpoint", "load_sharded_checkpoint", "save_sharded_checkpoint"]
