"""Tutorial 1: understanding discrete canonicalization.

A C4 canonicalizer, a GCNN energy over the four quarter turns, is fed the
four quarter turns of one image. It (a) selects group elements shifted by
the applied rotation and (b) turns every copy into the same canonical
image. The prior loss then pulls the selected pose toward the identity:
its gradient reaches the energy network through the raw activations.

The copies are an NHWC-contiguous batch, so on the card the select is the
channels-last kernel (K3).

    python -m equiadapt_tpu_torch.tutorials.understanding_discrete_canonicalization

On the CPU: `main(device="cpu")`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from equiadapt_tpu_torch.common import prior_regularization_loss
from equiadapt_tpu_torch.images import (
    EquivariantNetwork,
    GroupEquivariantImageCanonicalization,
)
from equiadapt_tpu_torch.tutorials._common import fp32, seeded

Tensor = torch.Tensor


def build_canonicalizer(size: int = 32, device="cuda") -> GroupEquivariantImageCanonicalization:
    """The C4 canonicalizer: a 2-layer GCNN energy (3 -> 8 channels, 3 x 3)."""
    net = EquivariantNetwork(in_channels=3, out_channels=8, kernel_size=3,
                             group_type="rotation", num_rotations=4, num_layers=2,
                             device=device)
    return GroupEquivariantImageCanonicalization(
        canonicalization_network=net, in_shape=(size, size, 3), num_rotations=4)


def quarter_turns(img: Tensor) -> Tensor:
    """(1, H, W, C) -> its four quarter turns, (4, H, W, C)."""
    return torch.cat([torch.rot90(img, k, dims=(1, 2)) for k in range(4)])


def run(canon: GroupEquivariantImageCanonicalization,
        copies: Tensor) -> Tuple[Tensor, Dict]:
    """Canonicalize the copies (eval) and back-propagate the prior loss:
    (x_canon, {selected, shifts, spread, grad_mass})."""
    canon.zero_grad(set_to_none=True)
    x_canon, info = canon(copies)
    prior_regularization_loss(info).backward()
    selected = info.group_activations.argmax(-1)
    out = {"selected": selected.tolist(),
           "shifts": ((selected - selected[0]) % 4).tolist(),
           "spread": (x_canon - x_canon[:1]).abs().max().item(),
           "grad_mass": sum(p.grad.abs().sum().item() for p in canon.parameters()
                            if p.grad is not None)}
    return x_canon.detach(), out


def main(device="cuda", size: int = 32, seed: int = 0) -> Dict:
    with seeded(seed, device):
        canon = build_canonicalizer(size, device)
    img = torch.randn(1, size, size, 3, device=device,
                      generator=torch.Generator(device=device).manual_seed(seed))
    with fp32():
        _, out = run(canon, quarter_turns(img))
    print("selected elements per rotated copy:", out["selected"])
    print("differences are the applied rotations:", out["shifts"])
    print(f"max deviation across canonicalized copies: {out['spread']:.2e}")
    print(f"gradient mass reaching the canonicalization network: {out['grad_mass']:.3f}")
    assert out["spread"] < 1e-3, out
    assert out["grad_mass"] > 0, out
    return out


if __name__ == "__main__":
    main()
