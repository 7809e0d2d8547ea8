"""Tutorial 3: prior-regularized promptable segmentation (SAM-style).

Images and their box / mask targets are canonicalized together by a C4
canonicalizer, a promptable segmentation model (`SAMLite`) is adapted to
the canonical frame under the prior regularization, and its predicted
masks are inverted back to the input frame. The prior weight biases the
canonical pose toward the identity: that is what lets a frozen pretrained
model work on unseen orientations.

On the card the targets' masks are selected by kernel K1a (one source),
the images by K3 (channels-last memory), and the inverted masks by K1a.
Inverting the canonicalized target masks gives the given masks back, bit
for bit.

    python -m equiadapt_tpu_torch.tutorials.instance_segmentation_group_equivariant_canonicalization

On the CPU: `main(device="cpu")`.
"""

from __future__ import annotations

from typing import Dict

import torch

from equiadapt_tpu_torch.data.coco import synthetic_coco_batch
from equiadapt_tpu_torch.images import (
    EquivariantNetwork,
    GroupEquivariantImageCanonicalization,
)
from equiadapt_tpu_torch.models.segmentation import SAMLite
from equiadapt_tpu_torch.pipelines.segmentation import (
    ImageSegmentationPipeline,
    create_segmentation_state,
    make_segmentation_train_step,
)
from equiadapt_tpu_torch.tutorials._common import fp32, seeded


def build_pipeline(size: int = 64, device="cuda") -> ImageSegmentationPipeline:
    """C4 GCNN canonicalizer (3 -> 4 channels, 3 x 3, 2 layers) and a
    SAMLite of width 64, one encoder and one decoder block, 2 heads."""
    net = EquivariantNetwork(in_channels=3, out_channels=4, kernel_size=3,
                             group_type="rotation", num_rotations=4, num_layers=2,
                             device=device)
    canon = GroupEquivariantImageCanonicalization(
        canonicalization_network=net, in_shape=(size, size, 3), num_rotations=4)
    sam = SAMLite(size, embed_dim=64, encoder_depth=1, decoder_depth=1, num_heads=2,
                  device=device)
    return ImageSegmentationPipeline(canonicalizer=canon, prediction_network=sam)


def main(device="cuda", size: int = 64, batch: int = 2, steps: int = 5,
         seed: int = 0) -> Dict:
    with seeded(seed, device):
        pipe = build_pipeline(size, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.Generator(device=device).manual_seed(seed + 1)  # dropout
    # Adam at 1e-3: AdamW without decay
    state = create_segmentation_state(pipe, learning_rate=1e-3, weight_decay=0.0)
    step = make_segmentation_train_step(prior_weight=100.0)
    with fp32():
        for _ in range(steps):
            b = synthetic_coco_batch(gen, batch, image_size=size, num_prompts=3)
            state, metrics = step(state, b, draws)
        train = {k: v.item() for k, v in metrics.items()}
        print({k: round(v, 4) for k, v in train.items()})
        # invert the predicted masks to the original orientation
        b = synthetic_coco_batch(gen, batch, image_size=size, num_prompts=3)
        with torch.no_grad():
            (_, targets_c, pred_masks, ious), info = pipe(b["image"], b["targets"])
            back = pipe.invert_masks(info, pred_masks)
            # the canonicalized target masks invert to the given ones exactly
            gt_back = pipe.invert_masks(info, targets_c["masks"].float())
    print("inverted mask batch:", tuple(back.shape), "ious:", tuple(ious.shape))
    assert back.shape == pred_masks.shape == (batch, 3, size, size), back.shape
    assert ious.shape == (batch, 3), ious.shape
    assert torch.equal(gt_back, b["targets"]["masks"].float()), "targets not restored"
    assert all(torch.isfinite(torch.tensor(v)) for v in train.values()), train
    assert bool(torch.isfinite(back).all()), "non-finite inverted masks"
    return {"train": train, "inverted_masks": list(back.shape), "ious": list(ious.shape),
            "selected": info.group_activations.argmax(-1).tolist()}


if __name__ == "__main__":
    main()
