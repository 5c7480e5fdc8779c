from repro_torch.utils.tree import (
    leaves,
    leaves_with_path,
    tree_add,
    tree_dot,
    tree_map,
    tree_scale,
    tree_sub,
    tree_zeros_like,
)

__all__ = ["leaves", "leaves_with_path", "tree_add", "tree_dot", "tree_map", "tree_scale", "tree_sub",
           "tree_zeros_like"]
