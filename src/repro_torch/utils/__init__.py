from repro_torch.utils.tree import (
    tree_add,
    tree_dot,
    tree_map,
    tree_scale,
    tree_sub,
    tree_zeros_like,
)

__all__ = ["tree_add", "tree_dot", "tree_map", "tree_scale", "tree_sub", "tree_zeros_like"]
