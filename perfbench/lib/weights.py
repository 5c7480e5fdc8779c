"""Weights of a configuration, made by the benchmark from ``--seed``.

One flat float32 buffer holds every leaf; a ``torch.Generator`` on the
buffer's device fills it with normal draws in a few large calls, clamped
at two standard deviations (a truncated fan-in init), and each leaf, a view
of the buffer, is then scaled by its own standard deviation (norm scales
are set to one). The same seed on the same device gives the same buffer,
so the reference regenerates the program's starting weights instead of
keeping a copy.

Leaves are named by the program's key path joined with dots
(``backbone.blocks.attn.wq``); sorted names follow the program's leaf order.
With ``slots`` every leaf leads with a slot axis: a cohort bank.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

FILL_CHUNK = 1 << 30  # values a generator call fills at a time


def dims(cfg: dict) -> Dict[str, int]:
    """The sizes a dense configuration file gives, by short names."""
    d = int(cfg["hidden_size"])
    h = int(cfg["num_attention_heads"])
    return {
        "L": int(cfg["num_hidden_layers"]),
        "D": d,
        "H": h,
        "Hkv": int(cfg["num_key_value_heads"]),
        "hd": int(cfg.get("head_dim") or d // h),
        "F": int(cfg["intermediate_size"]),
        "V": int(cfg["vocab_size"]),
    }


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """(name, shape, std) of every leaf of a dense decoder with a tied
    embedding, sorted by name; std None marks a norm scale (ones)."""
    if cfg.get("family") != "dense" or not cfg.get("tie_word_embeddings"):
        raise ValueError("the benchmark's weights cover the dense family with a tied embedding")
    s = dims(cfg)
    L, D, H, Hkv, hd, F, V = (s[k] for k in ("L", "D", "H", "Hkv", "hd", "F", "V"))
    out = [
        ("backbone.blocks.attn.wk", (L, D, Hkv, hd), D ** -0.5),
        ("backbone.blocks.attn.wo", (L, H, hd, D), (H * hd) ** -0.5),
        ("backbone.blocks.attn.wq", (L, D, H, hd), D ** -0.5),
        ("backbone.blocks.attn.wv", (L, D, Hkv, hd), D ** -0.5),
        ("backbone.blocks.attn_norm.scale", (L, D), None),
        ("backbone.blocks.mlp.wd", (L, F, D), F ** -0.5),
        ("backbone.blocks.mlp.wg", (L, D, F), D ** -0.5),
        ("backbone.blocks.mlp.wu", (L, D, F), D ** -0.5),
        ("backbone.blocks.mlp_norm.scale", (L, D), None),
        ("embed", (V, D), 0.02),
        ("final_norm.scale", (D,), None),
    ]
    return sorted(out)


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout(cfg))


def make(cfg: dict, seed: int, device, slots: int = 0) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout(cfg)`` (with a leading ``slots`` axis when
    given), as views of one buffer drawn from ``seed`` on ``device``."""
    lead = (slots,) if slots else ()
    lay = layout(cfg)
    sizes = [math.prod(lead + shape) for _, shape, _ in lay]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    gen = torch.Generator(device=flat.device)
    gen.manual_seed(int(seed) % (1 << 63))
    for a in range(0, flat.numel(), FILL_CHUNK):
        flat[a:a + FILL_CHUNK].normal_(generator=gen)
    flat.clamp_(-2.0, 2.0)
    out, off = {}, 0
    for (name, shape, std), n in zip(lay, sizes):
        leaf = flat[off:off + n].view(lead + shape)
        if std is None:
            leaf.fill_(1.0)
        else:
            leaf.mul_(std)
        out[name] = leaf
        off += n
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """Dotted names to the program's nested dict of leaves."""
    tree: dict = {}
    for name, leaf in flat.items():
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of ``nest``."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, name))
        else:
            out[name] = v
    return out
