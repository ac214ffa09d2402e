"""The multi-class GossipNet's weights (config 3), made from the seed on
the device, as ``weights.py`` makes config 2's.

One generator on the device draws every weight in one call, in float32,
under the model's ``state_dict`` names: first the class embedding
``class_embed.weight`` [classes, embedding width] of standard deviation
1/sqrt(embedding width), as flax's ``Embed`` and the program's
``params.init_params`` initialise it, so each class's 32 inputs of
``init_fc`` are of the size of the score and the rank beside them; then
config 2's weights (``weights.shapes``) with ``init_fc`` taking
2 + embedding width inputs (34) and each block's ``pair_wg`` nine rows,
the ninth the class match's. Matrices are LeCun-normal, biases of
standard deviation 0.1 and each ``expand_out`` scaled by
1/sqrt(2 x blocks), for the reasons ``weights.py`` gives.
"""

from __future__ import annotations

import math

import torch

from portbench import weights

NUM_PAIR_FEATURES = 9     # the eight of config 2 and the class match


def shapes(model: dict) -> list[tuple[str, tuple, float]]:
    """(name, shape, standard deviation) of every weight of a multi-class
    model with ``model``'s widths, in a fixed order."""
    width = model["class_embed_dim"]
    phi = 1 + int(model.get("score_rank_feature", True)) + width
    residual = 1.0 / math.sqrt(2 * model["num_blocks"])
    out = [("class_embed.weight", (model["num_classes"], width),
            1.0 / math.sqrt(width))]
    for name, shape, fan_in in weights.shapes(model):
        if name == "init_fc.weight":
            shape, fan_in = (shape[0], phi), phi
        elif name.endswith("pair_wg"):
            shape, fan_in = (NUM_PAIR_FEATURES, shape[1]), NUM_PAIR_FEATURES
        std = 1.0 / math.sqrt(fan_in) if fan_in else 0.1
        if name.endswith("expand_out.weight"):
            std *= residual
        out.append((name, shape, std))
    return out


def make(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The weights of ``seed``: the same values for the same seed on one
    kind of device."""
    spec = shapes(model)
    sizes = [math.prod(s) for _, s, _ in spec]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    return {name: (part * std).reshape(shape).contiguous()
            for (name, shape, std), part in zip(spec, flat.split(sizes))}


def parameter_count(model: dict) -> int:
    return sum(math.prod(s) for _, s, _ in shapes(model))
