"""Command-line entry points of the port (`python -m equiadapt_tpu_torch.cli.<name>`):
`classification_train`, `classification_serve`, `segmentation_serve`, `nbody_train`,
`pointcloud_train`, `partseg_train`, `segmentation_train` and
`maskrcnn_lite_experiment`."""

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one stream of draws of a run seeded `seed`."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + stream)
