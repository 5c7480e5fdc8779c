"""What the entries share: the program's model for a configuration file,
held to the file's sizes, and the program's leaves by the benchmark's names."""
from __future__ import annotations

import gc

import torch

from perfbench.lib import weights as wts


def model_of(cfg: dict):
    """The program's model of ``cfg["program_arch"]``, checked against the
    file: its parameters must be the benchmark's layout, leaf for leaf.
    ``program_sizes`` (the tests' small files) resizes the program's config."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.tree import leaves_with_path

    model = build_model(get_config(cfg["program_arch"]).replace(**cfg.get("program_sizes", {})))
    mine = {n: tuple(shape) for n, shape, _ in wts.layout(cfg)}
    theirs = {path[2:-2].replace("']['", "."): tuple(t.shape)
              for path, t in leaves_with_path(model.init_shapes())}
    if mine != theirs:
        raise RuntimeError(f"the program's {cfg['program_arch']} is not the file's configuration: "
                           f"{sorted(set(mine.items()) ^ set(theirs.items()))}")
    mc = model.cfg
    if (float(mc.rope_theta), float(mc.norm_eps)) != (float(cfg["rope_theta"]), float(cfg["rms_norm_eps"])):
        raise RuntimeError("the program's rope theta or norm epsilon differs from the file's")
    return model


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
