"""GossipNet's weights, made from the seed on the device.

One generator on the device draws every weight in one call, in float32
(the type they are served and trained in): LeCun-normal matrices
(standard deviation 1/sqrt(fan_in)) and biases of standard deviation 0.1,
so a dropped bias shows in the comparison. The last layer of each
residual branch (``expand_out``) is scaled by 1/sqrt(2 x blocks), as
GPT-2 scales its residual projections: without it a random 16-block
stack amplifies a one-ulp difference in a sum into a bf16 rounding of
h1 that moves a score by 1e-2, so a run's scores would hang on the
order of its sums and not on its arithmetic. The names are the model's
``state_dict`` names; the pair weights keep their (in, out) orientation,
the ``nn.Linear`` weights are (out, in). The port and the reference read
the same tensors; neither makes its own.
"""

from __future__ import annotations

import math

import torch

NUM_PAIR_FEATURES = 8


def shapes(model: dict) -> list[tuple[str, tuple, int]]:
    """(name, shape, fan_in; 0 for a bias) of every weight of a
    single-class model with ``model``'s widths, in a fixed order."""
    fd, rd = model["feature_dim"], model["reduced_dim"]
    p = model["pairwise_dim"]
    phi = 1 + int(model.get("score_rank_feature", True))
    out = []

    def linear(name, fan_in, fan_out):
        out.append((f"{name}.weight", (fan_out, fan_in), fan_in))
        out.append((f"{name}.bias", (fan_out,), 0))

    linear("init_fc", phi, fd)
    for k in range(model["num_blocks"]):
        b = f"blocks.{k}."
        linear(b + "reduce", fd, rd)
        out += [(b + "pair_wa", (rd, p), rd), (b + "pair_wb", (rd, p), rd),
                (b + "pair_wg", (NUM_PAIR_FEATURES, p), NUM_PAIR_FEATURES),
                (b + "pair_b1", (p,), 0), (b + "pair_w2", (p, p), p),
                (b + "pair_b2", (p,), 0)]
        for i in range(model.get("expand_hidden_layers", 2) - 1):
            linear(b + ("expand" if i == 0 else f"expand_h{i}"), p, p)
        linear(b + "expand_out", p, fd)
    linear("head", fd, 1)
    return out


def make(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The weights of ``seed``: the same values for the same seed on one
    kind of device."""
    spec = shapes(model)
    sizes = [math.prod(s) for _, s, _ in spec]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    residual = 1.0 / math.sqrt(2 * model["num_blocks"])
    out = {}
    for (name, shape, fan_in), part in zip(spec, flat.split(sizes)):
        std = 1.0 / math.sqrt(fan_in) if fan_in else 0.1
        if name.endswith("expand_out.weight"):
            std *= residual
        out[name] = (part * std).reshape(shape).contiguous()
    return out


def parameter_count(model: dict) -> int:
    return sum(math.prod(s) for _, s, _ in shapes(model))
