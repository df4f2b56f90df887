"""MVSNet's weights, made from the seed.

One generator on the device and one ``randn`` call for every value of
every leaf, in f32 (the type the port keeps its parameters in: it casts
them per conv), then each leaf scaled as the port's ``random_init_`` scales
it: conv weights He-normal over their fan-in (a transposed conv at stride 2
sees ~1/8 of its taps), conv biases small, BatchNorm scales and running
variances near 1, shifts and running means near 0. The keys are the
reference MVSNet's state-dict keys, which the port's modules share, so both
sides load the same dict.
"""

from __future__ import annotations

import math

import torch


def make_state_dict(template: dict[str, torch.Tensor], seed: int, device) -> dict[str, torch.Tensor]:
    """Values for every float leaf of ``template`` (a state dict: names and
    shapes), drawn from ``seed`` on ``device``; integer buffers are zeros."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    floats = {k: v for k, v in template.items() if v.is_floating_point()}
    flat = torch.randn(sum(v.numel() for v in floats.values()), generator=gen, device=device)
    out, at = {}, 0
    for key, like in template.items():
        if not like.is_floating_point():
            out[key] = torch.zeros(like.shape, dtype=like.dtype, device=device)
            continue
        z = flat[at:at + like.numel()].view(like.shape)
        at += like.numel()
        out[key] = _scale(key, z, template)
    return out


def _scale(key: str, z: torch.Tensor, template: dict[str, torch.Tensor]) -> torch.Tensor:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "weight" and z.dim() > 1:
        transposed = _is_transposed(key, template)
        fan_in = z.shape[0] * z[0, 0].numel() / 8 if transposed else z[0].numel()
        return z * math.sqrt(2.0 / fan_in)
    if leaf == "bias" and _is_conv(key, template):
        return z * 0.1
    if leaf == "weight":  # BatchNorm scale
        return 1.0 + 0.1 * z
    if leaf in ("bias", "running_mean"):
        return 0.1 * z
    if leaf == "running_var":
        return 1.0 + 0.1 * z.abs()
    raise KeyError(f"no rule for the leaf {key}")


def _is_conv(key: str, template) -> bool:
    return template[key.rsplit(".", 1)[0] + ".weight"].dim() > 1


def _is_transposed(key: str, template) -> bool:
    """The decoder stages' ConvTranspose3d are child ``0`` of a module whose
    child ``1`` is their BatchNorm (``conv7.0.weight`` beside
    ``conv7.1.running_var``)."""
    prefix = key.rsplit(".", 1)[0]
    return prefix.endswith(".0") and (prefix[:-2] + ".1.running_var") in template


def stereo_state_dict(out: dict[str, torch.Tensor], sharpness: float,
                      deep_scale: float = 0.1) -> dict[str, torch.Tensor]:
    """A plane-sweep stereo laid over CostRegNet's weights in ``out``, so
    that the forward sees depth without training: conv0 (its
    BatchNorm the identity) averages the cost volume's variance over the
    channels at the centre tap, the rest of the U-Net keeps ``deep_scale`` of
    its random weights, and the last conv weighs the 8 channels by
    ``-sharpness`` at its centre tap: the logits fall with the variance, and
    the softmax picks the planes where the views agree. Every weight keeps a
    random part, so every layer's arithmetic shows in the output. Changes
    ``out`` (``make_state_dict``'s weights) in place and returns it."""
    for key, value in out.items():
        if key.startswith("cost_regularization.") and key.endswith("weight") and value.dim() == 5:
            value.mul_(deep_scale)
    w0 = out["cost_regularization.conv0.conv.weight"]
    w0[:, :, 1, 1, 1] += 1.0 / w0.shape[1]
    bn = "cost_regularization.conv0.bn."
    out[bn + "weight"].fill_(1.0)
    out[bn + "bias"].zero_()
    out[bn + "running_mean"].zero_()
    out[bn + "running_var"].fill_(1.0)
    out["cost_regularization.prob.weight"][:, :, 1, 1, 1] -= sharpness
    return out


def stereo_weights(template: dict[str, torch.Tensor], seed: int, device, images: torch.Tensor, sharpness: float,
                   deep_scale: float = 0.1) -> dict[str, torch.Tensor]:
    """``stereo_state_dict`` with its sharpness per unit of the features'
    variance on ``images`` (the seed's own scenes), so that the softmax is
    as sharp for every seed."""
    out = make_state_dict(template, seed, device)
    return stereo_state_dict(out, sharpness / feature_variance(out, images, device), deep_scale)



def feature_variance(state: dict[str, torch.Tensor], images: torch.Tensor, device) -> float:
    """The mean over channels of the variance over pixels of FeatureNet's
    features of ``images`` (u8 [N, H, W, 3]), in eval mode as the program
    serves: the scale of the cost volume that the stereo's sharpness
    divides by."""
    from .reference.mvsnet import FeatureNet

    net = FeatureNet().to(device).eval()
    net.load_state_dict({k[len("feature."):]: v for k, v in state.items() if k.startswith("feature.")})
    with torch.no_grad():
        f = net(images.to(device).permute(0, 3, 1, 2).float() / 255.0)
    return float(f.var(dim=(2, 3)).mean())

