"""K3's texture feature sets in dense mode: the port's `bounce_ref`
against the JAX package's `pb.bounce(..., interpret=True)` (after its
`patch_image_weight`) on simpleLight (perlin, marble, turbulent noise),
quads (an image on a quad, a marble quad) and book2 (every feature: the
image on a sphere, marble, glass, two media, 1,006 spheres and 400
boxes). The cases and tolerances are tests/test_torch_bounce_features.py's
(`dense_case`, `FLIP`)."""

import pytest
import torch

from tests.test_torch_bounce_features import TEXTURED, dense_case

torch.set_num_threads(2)


@pytest.mark.parametrize("name", TEXTURED)
def test_dense_mode_texture_feature_sets(name):
    dense_case(name)
